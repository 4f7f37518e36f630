// Phase A of the block tracer: the root cull, the direction-bin sort, the
// blocking of the rays and the candidate lists of one tracer call.
//
// Replaces: no TPU kernel.  The reference computes phase A
// (ops/blocktrace.py::_root_cull, _octant_perm, _select_candidates) as XLA
// operations that its compiler fuses around the Pallas call; the port's
// plain version (ops/blocktrace.py::block_inputs_plain) spells it as ~150
// torch operators, a radix sort and a host sync a call.  These kernels give
// the plain version's outputs bit for bit: 1 launch for unsorted rays (the
// camera's), 3 for sorted ones (bounce and shadow rays).
//
// What bounds it on the H100: the host.  A call over 262,144 rays reads 28
// bytes a ray and writes 28 (36 with the sort's int64 permutation), ~15 MB
// or ~5 us at 3.35 TB/s; the slab tests are ~100 float operations per
// (block, candidate), nothing at 1,024 blocks x 8 clusters.  A launch costs
// the host microseconds, so the design is few launches and no host sync.
//
// Design:
//  * select (1 launch): a CTA per block of B rays, a thread a lane.  On
//    unsorted rays the CTA first reduces the C cluster boxes to the root box
//    itself (exact: a min and a max, as torch takes them) and culls its
//    lanes; padding lanes take origin 3e30, direction (1, 0, 0) and t_max 0,
//    and the CTA writes the blocked rays.  The block's bundle bounds are 13
//    reductions in one pass (warp shuffles, then one warp over the warps).
//    Every candidate's interval slab test goes to shared memory as (score,
//    index), score = -entry where the box overlaps and -inf where not; a
//    bitonic sort of the pairs, padded to a power of two, gives torch's
//    stable descending order, and the first U pairs are the list, padded
//    with the sentinel cluster to whole chunks.  The hierarchical route runs
//    the same steps on the parent boxes, then on the 4 children of each
//    selected parent.  The pairs take 13 bytes a candidate (score, index,
//    entry, overlap flag), rounded up to a power of two, and 5 a selected
//    parent: up to kMaxCandidates = 16,384 a stage, ~208 KB, in the opt-in
//    dynamic shared memory of one CTA (227 KB on the H100; above 48 KB the
//    launch raises the kernel's limit first);
//  * sort (2 launches before select): the stable sort by (dead, direction
//    bin) is a counting sort over 25 keys.  keys: a CTA of 1,024 rays culls
//    and keys them and writes its histogram; scatter: the same CTA culls and
//    keys again, takes its base for each key from the totals of the smaller
//    keys and the histograms of the CTAs before it (the prefix read whole by
//    every CTA: 6,400 integers at 262,144 rays), ranks its rays stably
//    within each key (__match_any_sync, then an exclusive prefix over the
//    warps), and writes the permuted rays straight into their blocks with
//    the int64 permutation.  The culled t_max is computed twice, the same
//    way, rather than kept between launches;
//  * torch's semantics to the bit: a min or max over an axis as torch's
//    CUDA reduction takes it (NaN first, ties to the lower index: the value
//    and its sign are one element's), elementwise minimum and maximum as
//    torch's (a NaN operand propagates, else fminf / fmaxf in the same
//    argument order), clamp_min likewise, IEEE division in inv_dir,
//    constants rounded from the plain version's doubles, and -fmad=false
//    (cuda_lib.py), so far * 1.0001 + 1e-4 and each slab product round as
//    the plain version's separate operations do.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// Sort keys: 24 direction bins (octant x dominant axis), then dead rays.
constexpr int kKeys = 25;
// Rays a CTA of the sort's kernels (ops/blocktrace.py _SORT_TILE).
constexpr int kTile = 1024;
// The most candidates one selection stage ranks in a CTA's shared memory
// (ops/blocktrace.py PHASE_A_MAX_CANDIDATES).
constexpr int kMaxCandidates = 16384;
// Dynamic shared memory a launch takes without raising the kernel's limit.
constexpr size_t kDefaultSmem = 48 * 1024;
// The bundle bounds: o_lo, iv_lo (minima), o_hi, iv_hi, t_max hi (maxima).
constexpr int kBundle = 13;
constexpr int kBundleMin = 6;
constexpr float kBig = static_cast<float>(1e30);
constexpr float kFarPad = static_cast<float>(3e30);
constexpr float kTiny = static_cast<float>(1e-12);
constexpr float kInflate = static_cast<float>(1.0001);
constexpr float kInflatePad = static_cast<float>(1e-4);

// A value and its index along the reduced axis.
struct Arg {
  float v;
  int i;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// torch's LessOrNan (kMax false) and GreaterOrNan (kMax true): the kept one
// of a and b.
template <bool kMax>
__device__ __forceinline__ Arg pick(Arg a, Arg b) {
  bool keep_a;
  if (a.v != a.v) {
    keep_a = b.v != b.v ? a.i < b.i : true;
  } else if (a.v == b.v) {
    keep_a = a.i < b.i;
  } else {
    keep_a = kMax ? a.v > b.v : a.v < b.v;
  }
  return keep_a ? a : b;
}

// torch.minimum, torch.maximum and torch.clamp_min on CUDA.
__device__ __forceinline__ float t_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// ops/intersect.py::inv_dir of one component.
__device__ __forceinline__ float inv_dir(float x) {
  return __fdiv_rn(x >= 0.0f ? 1.0f : -1.0f, t_clamp_min(fabsf(x), kTiny));
}

// Reduces a[q] over the CTA, by torch's min for q < n_min and its max for
// the others; out[q] gets the value kept.  blockDim.x is whole warps, every
// thread calls it, and it ends with a barrier.
template <int kQ>
__device__ void block_reduce(Arg (&a)[kQ], int n_min, float* out,
                             Arg* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Arg b{__shfl_down_sync(kFull, a[q].v, off),
                  __shfl_down_sync(kFull, a[q].i, off)};
      a[q] = q < n_min ? pick<false>(a[q], b) : pick<true>(a[q], b);
    }
    if (lane == 0) scratch[q * kMaxWarps + warp] = a[q];
  }
  __syncthreads();
  if (threadIdx.x < kQ) {
    const int q = threadIdx.x;
    Arg r = scratch[q * kMaxWarps];
    for (int w = 1; w < int(blockDim.x >> 5); ++w) {
      const Arg b = scratch[q * kMaxWarps + w];
      r = q < n_min ? pick<false>(r, b) : pick<true>(r, b);
    }
    out[q] = r.v;
  }
  __syncthreads();
}

// The root box of _root_cull: box[0..2] the min over the clusters' lower
// corners, box[3..5] the max over their upper ones.
__device__ void root_box(const float* __restrict__ cmin,
                         const float* __restrict__ cmax, int c, float* box,
                         Arg* scratch) {
  Arg a[6];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    a[q] = Arg{pos_inf(), 0x7fffffff};       // never kept over a cluster
    a[q + 3] = Arg{-pos_inf(), 0x7fffffff};
  }
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      a[q] = pick<false>(a[q], Arg{cmin[3 * j + q], j});
      a[q + 3] = pick<true>(a[q + 3], Arg{cmax[3 * j + q], j});
    }
  }
  block_reduce<6>(a, 3, box, scratch);
}

// _root_cull for one ray: its t_max clipped to the inflated exit of the
// root box, or 0 where it misses the box.
__device__ __forceinline__ float cull(const float (&o)[3], const float (&d)[3],
                                      float t_max, const float* box,
                                      float t_min) {
  Arg lo_t{0.0f, 0}, hi_t{0.0f, 0};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float inv = inv_dir(d[q]);
    const float t0 = (box[q] - o[q]) * inv;
    const float t1 = (box[3 + q] - o[q]) * inv;
    const Arg lo{t_minimum(t0, t1), q}, hi{t_maximum(t0, t1), q};
    lo_t = q ? pick<true>(lo_t, lo) : lo;
    hi_t = q ? pick<false>(hi_t, hi) : hi;
  }
  const float far_inf = hi_t.v * kInflate + kInflatePad;
  const bool hit = lo_t.v <= far_inf && far_inf >= t_min && lo_t.v <= t_max;
  return hit ? t_minimum(t_max, far_inf) : 0.0f;
}

// dir_bin, or the dead key where t_max <= 0 (_octant_perm's key).
__device__ __forceinline__ int sort_key(const float (&d)[3], float tm) {
  if (!(tm > 0.0f)) return kKeys - 1;
  const int octant = (d[0] < 0.0f) * 4 + (d[1] < 0.0f) * 2 + (d[2] < 0.0f);
  const float a0 = fabsf(d[0]), a1 = fabsf(d[1]), a2 = fabsf(d[2]);
  const int dom = a0 >= t_maximum(a1, a2) ? 0 : (a1 >= a2 ? 1 : 2);
  return octant * 3 + dom;
}

__device__ __forceinline__ void load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ t_max,
                                         int t_max_step, float t_max_value,
                                         long long i, float (&ro)[3],
                                         float (&rd)[3], float& tm) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    ro[q] = o[3 * i + q];
    rd[q] = d[3 * i + q];
  }
  tm = t_max ? t_max[i * t_max_step] : t_max_value;
}

__device__ __forceinline__ void store_ray(float* __restrict__ o,
                                          float* __restrict__ d,
                                          float* __restrict__ t_max,
                                          long long p, const float (&ro)[3],
                                          const float (&rd)[3], float tm) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    o[3 * p + q] = ro[q];
    d[3 * p + q] = rd[q];
  }
  t_max[p] = tm;
}

// A padding lane of block_inputs_plain: origin 3e30, direction (1, 0, 0),
// t_max 0.
__device__ __forceinline__ void store_padding(float* __restrict__ o,
                                              float* __restrict__ d,
                                              float* __restrict__ t_max,
                                              long long p) {
  const float ro[3] = {kFarPad, kFarPad, kFarPad};
  const float rd[3] = {1.0f, 0.0f, 0.0f};
  store_ray(o, d, t_max, p, ro, rd, 0.0f);
}

// _interval_slab_local for one box against the block's bundle bounds
// (bnd: o_lo, iv_lo, o_hi, iv_hi, t_max hi) -> the entry clamp_min(near_lo,
// 0), and whether the box overlaps.
__device__ __forceinline__ float slab(const float* __restrict__ amin,
                                      const float* __restrict__ amax,
                                      const float* bnd, float t_min,
                                      bool* overlap) {
  Arg lo_t{0.0f, 0}, hi_t{0.0f, 0};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float il = bnd[3 + q], ih = bnd[9 + q];
    // amin - o_hi, amin - o_lo, amax - o_hi, amax - o_lo
    const float a[4] = {amin[q] - bnd[6 + q], amin[q] - bnd[q],
                        amax[q] - bnd[6 + q], amax[q] - bnd[q]};
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c1 = a[j] * il, c2 = a[j] * ih;
      lo[j] = t_minimum(c1, c2);
      hi[j] = t_maximum(c1, c2);
    }
    const float t0_lo = t_minimum(lo[0], lo[1]), t0_hi = t_maximum(hi[0], hi[1]);
    const float t1_lo = t_minimum(lo[2], lo[3]), t1_hi = t_maximum(hi[2], hi[3]);
    const Arg n{t_minimum(t0_lo, t1_lo), q}, f{t_maximum(t0_hi, t1_hi), q};
    lo_t = q ? pick<true>(lo_t, n) : n;
    hi_t = q ? pick<false>(hi_t, f) : f;
  }
  *overlap = lo_t.v <= hi_t.v && hi_t.v >= t_min && lo_t.v <= bnd[kBundle - 1];
  return t_clamp_min(lo_t.v, 0.0f);
}

// Whether pair (sa, ia) comes before (sb, ib) in torch's stable descending
// sort: the larger score first, the lower index among equal scores, a NaN
// score before any other.
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  const bool na = sa != sa, nb = sb != sb;
  if (na || nb) return na && (!nb || ia < ib);
  return sa > sb || (sa == sb && ia < ib);
}

// Sorts the pairs (score[i], id[i]), i < p (a power of two), into that
// order.  Every thread calls it; it ends with a barrier.
__device__ void bitonic(float* score, int* id, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < p / 2; q += blockDim.x) {
        const int i = 2 * q - (q & (stride - 1));
        const int j = i + stride;
        const float si = score[i], sj = score[j];
        const int ii = id[i], ij = id[j];
        const bool swap = (i & size) == 0 ? before(sj, ij, si, ii)
                                          : before(si, ii, sj, ij);
        if (swap) {
          score[i] = sj;
          score[j] = si;
          id[i] = ij;
          id[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int m) {
  int p = 1;
  while (p < m) p <<= 1;
  return p;
}

// The sort's first pass: per CTA of kTile rays, the count of each key.
__global__ void __launch_bounds__(kTile) phase_a_keys_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, int t_max_step, float t_max_value,
    int n, const float* __restrict__ cmin, const float* __restrict__ cmax,
    int c, float t_min, int* __restrict__ hist) {
  __shared__ Arg scratch[6 * kMaxWarps];
  __shared__ float box[6];
  __shared__ int count[kKeys];
  if (threadIdx.x < kKeys) count[threadIdx.x] = 0;
  root_box(cmin, cmax, c, box, scratch);
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  if (i < n) {
    float ro[3], rd[3], tm;
    load_ray(o, d, t_max, t_max_step, t_max_value, i, ro, rd, tm);
    atomicAdd(&count[sort_key(rd, cull(ro, rd, tm, box, t_min))], 1);
  }
  __syncthreads();
  if (threadIdx.x < kKeys) hist[blockIdx.x * kKeys + threadIdx.x] = count[threadIdx.x];
}

// The sort's second pass: each ray to its place in the stable order, the
// padding lanes after the last ray.
__global__ void __launch_bounds__(kTile) phase_a_scatter_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, int t_max_step, float t_max_value,
    int n, int n_pad, const float* __restrict__ cmin,
    const float* __restrict__ cmax, int c, float t_min,
    const int* __restrict__ hist, int n_tiles, float* __restrict__ o_s,
    float* __restrict__ d_s, float* __restrict__ tm_s,
    long long* __restrict__ perm) {
  __shared__ Arg scratch[6 * kMaxWarps];
  __shared__ float box[6];
  __shared__ int base[kKeys];
  __shared__ int total[kKeys];
  __shared__ int warp_off[kMaxWarps][kKeys];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kMaxWarps * kKeys; j += blockDim.x)
    (&warp_off[0][0])[j] = 0;
  // Warp k sums key k over the CTAs before this one and over all of them.
  if (warp < kKeys) {
    int below = 0, all = 0;
    for (int t = lane; t < n_tiles; t += 32) {
      const int h = hist[t * kKeys + warp];
      all += h;
      if (t < int(blockIdx.x)) below += h;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      below += __shfl_xor_sync(kFull, below, off);
      all += __shfl_xor_sync(kFull, all, off);
    }
    if (lane == 0) {
      base[warp] = below;
      total[warp] = all;
    }
  }
  root_box(cmin, cmax, c, box, scratch);      // its barriers publish base
  if (threadIdx.x == 0) {
    int run = 0;
    for (int k = 0; k < kKeys; ++k) {
      base[k] += run;
      run += total[k];
    }
  }
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  float ro[3], rd[3], tm = 0.0f;
  int key = kKeys;                            // no ray
  if (live) {
    load_ray(o, d, t_max, t_max_step, t_max_value, i, ro, rd, tm);
    tm = cull(ro, rd, tm, box, t_min);
    key = sort_key(rd, tm);
  }
  // Stable rank within the warp, then the warps' exclusive prefix per key.
  const unsigned same = __match_any_sync(kFull, key);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (live && rank == 0) warp_off[warp][key] = __popc(same);
  __syncthreads();
  if (threadIdx.x < kKeys) {
    int run = 0;
    for (int w = 0; w < kMaxWarps; ++w) {
      const int cnt = warp_off[w][threadIdx.x];
      warp_off[w][threadIdx.x] = run;
      run += cnt;
    }
  }
  __syncthreads();
  if (live) {
    const long long p = (long long)base[key] + warp_off[warp][key] + rank;
    store_ray(o_s, d_s, tm_s, p, ro, rd, tm);
    perm[p] = i;
  }
  if (blockIdx.x == 0 && int(threadIdx.x) < n_pad - n)
    store_padding(o_s, d_s, tm_s, (long long)n + threadIdx.x);
}

// The candidate list of a block of blockDim.x rays (blockIdx.x): u_idx and
// u_entry [n_blocks, n_u_pad], n_valid [n_blocks].  Unsorted (kSorted
// false): culls, pads and writes the blocked rays ob, db, tmb first;
// sorted: reads them (phase_a_scatter_kernel wrote them).  n_sel > 0 takes
// the hierarchical route over n_par parents.
template <bool kSorted>
__global__ void __launch_bounds__(1024) phase_a_select_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, int t_max_step, float t_max_value,
    int n, const float* __restrict__ cmin, const float* __restrict__ cmax,
    int c, const float* __restrict__ pmin, const float* __restrict__ pmax,
    int n_par, int n_sel, int p_cap, int n_u, int n_u_pad, float t_min,
    float* __restrict__ ob, float* __restrict__ db, float* __restrict__ tmb,
    int* __restrict__ u_idx, float* __restrict__ u_entry,
    int* __restrict__ n_valid) {
  // [p_cap] scores, ids and entries, [n_sel] parents, [p_cap] overlap
  // flags, [n_sel] parent flags.
  extern __shared__ float4 dyn[];
  float* score = reinterpret_cast<float*>(dyn);
  int* id = reinterpret_cast<int*>(score + p_cap);
  float* entry = reinterpret_cast<float*>(id + p_cap);
  int* sel = reinterpret_cast<int*>(entry + p_cap);
  unsigned char* ovl = reinterpret_cast<unsigned char*>(sel + n_sel);
  unsigned char* sel_ok = ovl + p_cap;
  __shared__ Arg scratch[kBundle * kMaxWarps];
  __shared__ float bnd[kBundle];
  __shared__ float box[6];
  __shared__ float lane0[6];
  __shared__ int n_ok;

  const int t = threadIdx.x, nt = blockDim.x;
  const long long lane_id = (long long)blockIdx.x * nt + t;
  float ro[3], rd[3], tm;
  if (kSorted) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      ro[q] = ob[3 * lane_id + q];
      rd[q] = db[3 * lane_id + q];
    }
    tm = tmb[lane_id];
  } else {
    root_box(cmin, cmax, c, box, scratch);
    if (lane_id < n) {
      load_ray(o, d, t_max, t_max_step, t_max_value, lane_id, ro, rd, tm);
      tm = cull(ro, rd, tm, box, t_min);
      store_ray(ob, db, tmb, lane_id, ro, rd, tm);
    } else {
      store_padding(ob, db, tmb, lane_id);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        ro[q] = kFarPad;
        rd[q] = q == 0 ? 1.0f : 0.0f;
      }
      tm = 0.0f;
    }
  }
  float inv[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) inv[q] = inv_dir(rd[q]);
  if (t == 0) {
    n_ok = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      lane0[q] = ro[q];
      lane0[3 + q] = inv[q];
    }
  }
  __syncthreads();
  // Bundle bounds: lanes with t_max <= 0 take lane 0's origin and inverse
  // direction; the t_max bound takes every lane's.
  const bool valid = tm > 0.0f;
  Arg a[kBundle];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float oq = valid ? ro[q] : lane0[q];
    const float iq = valid ? inv[q] : lane0[3 + q];
    a[q] = Arg{oq, t};
    a[3 + q] = Arg{iq, t};
    a[6 + q] = Arg{oq, t};
    a[9 + q] = Arg{iq, t};
  }
  a[kBundle - 1] = Arg{tm, t};
  block_reduce<kBundle>(a, kBundleMin, bnd, scratch);

  // The first stage: every cluster (flat), or every parent.
  const int m1 = n_sel ? n_par : c;
  const float* amin = n_sel ? pmin : cmin;
  const float* amax = n_sel ? pmax : cmax;
  int p = pow2_at_least(m1);
  for (int q = t; q < p; q += nt) {
    float s = -pos_inf();
    if (q < m1) {
      bool ov;
      const float en = slab(amin + 3 * q, amax + 3 * q, bnd, t_min, &ov);
      if (ov) s = -en;
      entry[q] = en;
      ovl[q] = ov;
    }
    score[q] = s;
    id[q] = q;
  }
  __syncthreads();
  bitonic(score, id, p);
  if (n_sel) {
    // The second stage: the 4 children of each selected parent.
    for (int r = t; r < n_sel; r += nt) {
      sel[r] = id[r];
      sel_ok[r] = ovl[id[r]];
    }
    __syncthreads();
    const int m2 = 4 * n_sel;
    p = pow2_at_least(m2);
    for (int q = t; q < p; q += nt) {
      float s = -pos_inf();
      if (q < m2) {
        const int child = sel[q >> 2] * 4 + (q & 3);
        const int safe = min(child, c - 1);
        bool ov;
        const float en = slab(cmin + 3 * safe, cmax + 3 * safe, bnd, t_min, &ov);
        ov = ov && child < c && sel_ok[q >> 2];
        if (ov) s = -en;
        entry[q] = en;
        ovl[q] = ov;
      }
      score[q] = s;
      id[q] = q;
    }
    __syncthreads();
    bitonic(score, id, p);
  }
  // The list: the first n_u pairs, the sentinel where a pair's box does not
  // overlap, and the sentinel to whole chunks.
  int mine = 0;
  for (int r = t; r < n_u_pad; r += nt) {
    int cl = c;
    float en = kBig;
    if (r < n_u) {
      const int s = id[r];
      if (ovl[s]) {
        cl = n_sel ? sel[s >> 2] * 4 + (s & 3) : s;
        en = entry[s];
        ++mine;
      }
    }
    u_idx[(long long)blockIdx.x * n_u_pad + r] = cl;
    u_entry[(long long)blockIdx.x * n_u_pad + r] = en;
  }
  if (mine) atomicAdd(&n_ok, mine);
  __syncthreads();
  if (t == 0) n_valid[blockIdx.x] = n_ok;
}

unsigned tiles(int n) { return unsigned((n + kTile - 1) / kTile); }

}  // namespace

// The sort's histograms: hist int32 [ceil(n / 1024), 25].  t_max is a
// per-ray array read at i * t_max_step, or t_max_value where it is null.
extern "C" int pbr_phase_a_keys(const float* o, const float* d,
                                const float* t_max, int t_max_step,
                                float t_max_value, int n, const float* cmin,
                                const float* cmax, int c, float t_min,
                                int* hist, void* stream) {
  if (n <= 0) return 0;
  if (c < 1) return int(cudaErrorInvalidValue);
  phase_a_keys_kernel<<<tiles(n), kTile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, t_max, t_max_step, t_max_value, n, cmin, cmax, c, t_min, hist);
  return int(cudaGetLastError());
}

// The sorted, culled rays padded to n_pad (o_s, d_s [n_pad, 3], tm_s
// [n_pad]) and perm int64 [n], from the histograms of pbr_phase_a_keys.
extern "C" int pbr_phase_a_scatter(const float* o, const float* d,
                                   const float* t_max, int t_max_step,
                                   float t_max_value, int n, int n_pad,
                                   const float* cmin, const float* cmax, int c,
                                   float t_min, const int* hist, float* o_s,
                                   float* d_s, float* tm_s, long long* perm,
                                   void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || n_pad < n || n_pad - n >= kTile) return int(cudaErrorInvalidValue);
  phase_a_scatter_kernel<<<tiles(n), kTile, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_max, t_max_step, t_max_value, n, n_pad, cmin, cmax, c, t_min,
      hist, int(tiles(n)), o_s, d_s, tm_s, perm);
  return int(cudaGetLastError());
}

// The candidate lists of n_blocks blocks of `block` rays.  sorted: ob, db,
// tmb hold the sorted rays (pbr_phase_a_scatter) and o, d, t_max are not
// read; else the rays are culled and blocked here.  n_sel > 0: the
// hierarchical route over the n_par parent boxes pmin, pmax.
extern "C" int pbr_phase_a_select(
    const float* o, const float* d, const float* t_max, int t_max_step,
    float t_max_value, int n, const float* cmin, const float* cmax, int c,
    const float* pmin, const float* pmax, int n_par, int n_sel, int n_u,
    int n_u_pad, float t_min, int sorted, int n_blocks, int block,
    float* ob, float* db, float* tmb, int* u_idx, float* u_entry,
    int* n_valid, void* stream) {
  if (n_blocks <= 0) return 0;
  const int m = n_sel ? (n_par > 4 * n_sel ? n_par : 4 * n_sel) : c;
  if (block % 32 != 0 || block < 32 || block > 1024 || c < 1 ||
      m > kMaxCandidates || n_u > m || n_u_pad < n_u)
    return int(cudaErrorInvalidValue);
  int p_cap = 1;
  while (p_cap < m) p_cap <<= 1;
  const size_t smem = size_t(p_cap) * 13 + size_t(n_sel) * 5;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = sorted ? phase_a_select_kernel<true>
                             : phase_a_select_kernel<false>;
  // Above 48 KB a kernel launches only under a raised limit; the card
  // refuses a limit past its opt-in maximum less the static arrays.
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();                     // not left for a later check
      return int(e);
    }
  }
  kernel<<<n_blocks, block, smem, s>>>(
      o, d, t_max, t_max_step, t_max_value, n, cmin, cmax, c, pmin, pmax,
      n_par, n_sel, p_cap, n_u, n_u_pad, t_min, ob, db, tmb, u_idx, u_entry,
      n_valid);
  return int(cudaGetLastError());
}
