// Fused whole-frame megakernel (K4): camera rays, the whole bounce loop
// (closest hit, emitter-hit MIS, NEE with shadow rays, GGX/Lambert BSDF
// sampling), the spp sum and the ray-query count in one launch.
//
// Replaces: the reference package's ops/fused.py::_make_kernel.kernel
// (:402), launched by render_fused_stats (:714-756).  The TPU kernel renders
// a [8, 512] tile of rays per grid step with every per-ray scalar a vector
// register and the scene tables in SMEM; here a thread traces one (pixel,
// sample) path at a time, and each block stages the tables into shared
// memory once.
//
// What bounds it on the H100: arithmetic and divergence.  Every bounce is a
// brute-force Moller-Trumbore over all triangles (46 float operations each,
// read from shared memory as broadcasts) plus one shadow pass per light
// family up to its first occluder; a 512x512, 4 spp, 4-bounce Cornell frame
// makes ~104M ray-triangle tests (~4.8 GFLOP; tools/work.py counts them)
// and writes only the 3 MB image.  The paths of a warp's lanes end at
// different bounces.
//
// Design:
//  * persistent threads: as many blocks of kThreads as the card holds at
//    once, at most 64 registers a thread (32 warps an SM); a lane takes the
//    next (pixel, sample) from a work counter (count[1]) whenever its path
//    ends, the lanes that ask at once with one atomic, so that no lane
//    idles while the others of its warp finish longer paths (Aila and
//    Laine, "Understanding the Efficiency of Ray Traversal on GPUs", HPG
//    2009).  Items are pixel-major: the samples of a pixel are neighbours;
//  * a path's radiance goes to the scratch samples[pixel][sample]; the
//    last sample of a pixel to finish (a per-pixel arrival counter) sums
//    them in sample order, ((0 + L0) + L1) + ..., as the plain version
//    does, so the image does not depend on the order paths end in;
//  * the block stages cam | geometry | tri | emitter | texture meta | quad
//    tables (20 + 12 T' + 32 T + 14 E + 6 M + 16 R floats, T' = T rounded
//    up to four) into dynamic shared memory, ~72 KB at the reference's
//    limits (340 triangles, 32 emitters, 160 texel rows), with the opt-in
//    above 48 KB (cudaFuncSetAttribute);
//  * a triangle's geometry is three float4s, (v0, 0) | (e1, 0) | (e2, 0),
//    so a test reads three 16-byte broadcasts; the shading columns stay in
//    the 32-float rows and are read for the winner only;
//  * tests run in groups of four with no branch: the reciprocal of det is
//    rcp_rn (rcp.cuh: equal to 1.0f / det for |det| in [1e-9, 2^126),
//    checked on every such float by pbr_rcp_check), and a group in which
//    some |det| reaches 2^126 runs again with the division, so results are
//    those of 1.0f / det.  IEEE division in the loop made every test a
//    basic block of its own (a branch and a slow-path call);
//  * the murmur3 counter RNG in uint32 arithmetic, keyed by (frame seeds,
//    pixel id, sample, draw site) exactly as the reference; the draw site
//    is 1, 2 for the jitter and 3 + 6b + k (with area emitters) or
//    3 + 3b + k (without) in bounce b;
//  * a path ends when it stops being active: from then on the reference
//    adds only zeros for it;
//  * the ray-query count is reduced per block (warp shuffles, then shared
//    memory) and added to an int64 with one atomic per block, so it is
//    exact;
//  * rounding: the library is built with -fmad=false and every expression
//    is written in the reference's (and the plain version's,
//    ops/fused.py) order; 1/sqrtf(x) stands for the reference's rsqrt
//    because CUDA's rsqrtf is approximate while sqrtf and the division round
//    correctly, as torch's sqrt and reciprocal do; max/min/clamp keep NaN
//    like torch's; constants are the reference's double literals rounded
//    once to float, as torch rounds a Python scalar.  Kernel and plain
//    version then differ only where sinf/cosf differ.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rcp.cuh"

namespace {

using pbr::kRcpHi;
using pbr::kRcpLo;
using pbr::rcp_rn;

constexpr int kThreads = 1024;
constexpr int kCamW = 20;  // 18 used, padded
constexpr int kGW = 12;    // geometry: three float4s a triangle
constexpr int kTW = 32;
constexpr int kEW = 14;
constexpr int kMW = 6;
constexpr int kQW = 16;
constexpr size_t kMaxSmem = 227 * 1024;

#define F(x) static_cast<float>(x)

constexpr float kBig = F(1e30);
constexpr float kHalfBig = F(0.5 * 1e30);
constexpr float kInvPi = F(0.31830988618379067);
constexpr float kTwoPi = F(6.283185307179586);
constexpr float kShadowScale = F(1.0 - 1e-3);
constexpr float kDirTMax = F(1e30 * (1.0 - 1e-3));

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 load3(const float* p) {
  return v3(p[0], p[1], p[2]);
}

// torch's clamp_min / clamp_max / clamp / maximum / minimum: NaN in, NaN out.
__device__ __forceinline__ float mx(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float mn(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float cl(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maxnan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minnan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, rsq(mx(dot(a, a), F(1e-20))));
}

__device__ __forceinline__ float power_mis(float pa, float pb) {
  const float a2 = pa * pa;
  return pa > 0.0f ? a2 / mx(a2 + pb * pb, F(1e-20)) : 0.0f;
}

// --- murmur3 counter RNG (reference _fmix32 / _make_rng) -----------------

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform(uint32_t pid, uint32_t seed0,
                                         uint32_t seed1, uint32_t s,
                                         uint32_t site) {
  uint32_t h = pid * 0x9E3779B1u;
  h ^= seed0;
  h = fmix32(h + site * 0x6C078965u);
  h ^= s * 0xB5297A4Du;
  h ^= seed1;
  h = fmix32(h);
  return static_cast<float>(static_cast<int>(h >> 8)) *
         (1.0f / 16777216.0f);
}

// --- BSDF (reference _bsdf_consts / _eval_bsdf / _sample_bsdf) ------------

struct Bsdf {
  float alpha, ps;
  V3 f0, diff;
};

__device__ __forceinline__ Bsdf bsdf_consts(V3 bc, float met, float rgh,
                                            float spc) {
  Bsdf b;
  const float r = cl(rgh, F(1e-2), 1.0f);
  b.alpha = mx(r * r, F(1e-4));
  const float one_m = 1.0f - met;
  b.f0 = v3(F(0.04) * spc * one_m + bc.x * met,
            F(0.04) * spc * one_m + bc.y * met,
            F(0.04) * spc * one_m + bc.z * met);
  b.diff = v3(bc.x * one_m, bc.y * one_m, bc.z * one_m);
  const float ls = mx(b.f0.x * F(0.2126) + b.f0.y * F(0.7152) +
                          b.f0.z * F(0.0722), F(1e-4));
  const float ld = mx(b.diff.x * F(0.2126) + b.diff.y * F(0.7152) +
                          b.diff.z * F(0.0722), 0.0f);
  b.ps = cl(ls / (ls + ld), F(0.05), F(0.99));
  return b;
}

__device__ __forceinline__ float smith_lambda(float alpha, float wz) {
  const float c = cl(fabsf(wz), F(1e-6), 1.0f);
  const float tan2 = mx(1.0f - c * c, 0.0f) / (c * c);
  return 0.5f * (sqrtf(1.0f + alpha * alpha * tan2) - 1.0f);
}

__device__ __forceinline__ float fr1(float c, float m5) {
  return c + (1.0f - c) * m5;
}

__device__ V3 eval_bsdf(V3 wo, V3 wi, const Bsdf& b, float* pdf) {
  const float no = wo.z;
  const float ni = wi.z;
  const bool valid = no > F(1e-6) && ni > F(1e-6);
  const V3 h = normalize(add(wo, wi));
  const float voh = mx(dot(wo, h), 0.0f);
  const float m = cl(1.0f - voh, 0.0f, 1.0f);
  const float m5 = (m * m) * (m * m) * m;
  const V3 fr = v3(fr1(b.f0.x, m5), fr1(b.f0.y, m5), fr1(b.f0.z, m5));
  const float a2 = b.alpha * b.alpha;
  const float nh = mx(h.z, 0.0f);
  const float dd = nh * nh * (a2 - 1.0f) + 1.0f;
  const float d_ggx = a2 * kInvPi / mx(dd * dd, F(1e-12));
  const float no_ = mx(fabsf(no), F(1e-6));
  const float ni_ = mx(fabsf(ni), F(1e-6));
  const float lam_o = smith_lambda(b.alpha, no);
  const float lam_i = smith_lambda(b.alpha, ni);
  const float vis = 1.0f / (4.0f * no_ * ni_ * (1.0f + lam_o + lam_i));
  const float dv = d_ggx * vis;
  const float pdf_d = mx(ni, 0.0f) * kInvPi;
  const float g1_o = 1.0f / (1.0f + lam_o);
  const float pdf_s = g1_o * d_ggx / (4.0f * no_);
  *pdf = valid ? b.ps * pdf_s + (1.0f - b.ps) * pdf_d : 0.0f;
  if (!valid) return v3(0.0f, 0.0f, 0.0f);
  return v3(b.diff.x * kInvPi * (1.0f - fr.x) + dv * fr.x,
            b.diff.y * kInvPi * (1.0f - fr.y) + dv * fr.y,
            b.diff.z * kInvPi * (1.0f - fr.z) + dv * fr.z);
}

__device__ V3 sample_bsdf(V3 wo, float u_lobe, float u1, float u2,
                          const Bsdf& b, V3* f, float* pdf) {
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float cphi = cosf(phi);
  const float sphi = sinf(phi);
  const V3 wi_d = v3(r * cphi, r * sphi, sqrtf(mx(1.0f - u1, 0.0f)));
  const V3 vh = normalize(v3(b.alpha * wo.x, b.alpha * wo.y, wo.z));
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv = rsq(mx(lensq, F(1e-12)));
  const bool big = lensq > F(1e-9);
  const V3 t1 = v3(big ? -vh.y * inv : 1.0f, big ? vh.x * inv : 0.0f, 0.0f);
  const V3 t2 = cross(vh, t1);
  const float p1 = r * cphi;
  float p2 = r * sphi;
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(mx(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(mx(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vh, p3));
  const V3 h = normalize(v3(b.alpha * nh.x, b.alpha * nh.y,
                            mx(nh.z, F(1e-6))));
  const V3 wi_s = sub(scale(h, 2.0f * dot(wo, h)), wo);
  const V3 wi = normalize(u_lobe < b.ps ? wi_s : wi_d);
  *f = eval_bsdf(wo, wi, b, pdf);
  return wi;
}

// Branchless orthonormal basis around unit n (Duff et al. 2017).
__device__ __forceinline__ void onb(V3 n, V3* t, V3* bt) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + n.z);
  const float b = n.x * n.y * a;
  *t = v3(1.0f + s * n.x * n.x * a, s * b, -s * n.x);
  *bt = v3(b, s + n.y * n.y * a, -n.y);
}

// --- tracing over the shared-memory geometry table ------------------------
//
// The geometry of triangle k is three float4s, (v0, 0) | (e1, 0) | (e2, 0),
// at geo[3k .. 3k + 2]: one test is three 16-byte broadcasts.  The table is
// padded with zero triangles to a multiple of four (det = 0: no hit).

// One Moller-Trumbore test.  kExact: inv = 1.0f / det; else rcp_rn(det),
// and *outside notes a |det| at or above kRcpHi, where rcp_rn is not
// checked.
template <bool kExact>
__device__ __forceinline__ bool mt(const float4* g, V3 o, V3 d, float t_min,
                                   float* tt, float* u, float* v,
                                   bool* outside) {
  const float4 a = g[0], b = g[1], c = g[2];
  const V3 v0 = v3(a.x, a.y, a.z);
  const V3 e1 = v3(b.x, b.y, b.z);
  const V3 e2 = v3(c.x, c.y, c.z);
  const V3 p = cross(d, e2);
  const float det = dot(p, e1);
  const float ad = fabsf(det);
  const bool nonzero = ad > kRcpLo;
  float inv;
  if (kExact) {
    inv = nonzero ? 1.0f / det : 0.0f;
  } else {
    *outside |= ad >= kRcpHi;
    inv = nonzero ? rcp_rn(det) : 0.0f;
  }
  const V3 tv = sub(o, v0);
  *u = dot(tv, p) * inv;
  const V3 q = cross(tv, e1);
  *v = dot(d, q) * inv;
  *tt = dot(e2, q) * inv;
  return nonzero && *u >= 0.0f && *v >= 0.0f && *u + *v <= 1.0f &&
         *tt > t_min;
}

// Triangles k0 .. k0 + 3 in index order against the best hit so far; a hit
// replaces it only at a strictly smaller t.  Returns mt's `outside`.
template <bool kExact>
__device__ __forceinline__ bool closest4(const float4* geo, int k0, V3 o,
                                         V3 d, float t_min, float* tb,
                                         float* ub, float* vb, int* best) {
  bool outside = false;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float tt, u, v;
    if (mt<kExact>(geo + 3 * (k0 + m), o, d, t_min, &tt, &u, &v,
                   &outside) &&
        tt < *tb) {
      *tb = tt;
      *ub = u;
      *vb = v;
      *best = k0 + m;
    }
  }
  return outside;
}

template <bool kExact>
__device__ __forceinline__ bool any4(const float4* geo, int k0, V3 o, V3 d,
                                     float t_min, float t_max, bool* hit) {
  bool outside = false;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float tt, u, v;
    *hit |= mt<kExact>(geo + 3 * (k0 + m), o, d, t_min, &tt, &u, &v,
                       &outside) &&
            tt < t_max;
  }
  return outside;
}

// Closest hit over n_pad (a multiple of four) triangles: ties go to the
// lowest triangle index; -1 and kBig on a miss.  The four tests of a group
// have no branch, so the scheduler interleaves them; a group in which some
// |det| reached kRcpHi runs again from the state before it, dividing, so
// results are always those of 1.0f / det.
__device__ int closest(const float4* geo, int n_pad, V3 o, V3 d, float t_min,
                       float* t_best, float* u_best, float* v_best) {
  float tb = kBig, ub = 0.0f, vb = 0.0f;
  int best = -1;
  for (int k0 = 0; k0 < n_pad; k0 += 4) {
    const float tb0 = tb, ub0 = ub, vb0 = vb;
    const int best0 = best;
    if (closest4<false>(geo, k0, o, d, t_min, &tb, &ub, &vb, &best)) {
      tb = tb0;
      ub = ub0;
      vb = vb0;
      best = best0;
      closest4<true>(geo, k0, o, d, t_min, &tb, &ub, &vb, &best);
    }
  }
  *t_best = tb;
  *u_best = ub;
  *v_best = vb;
  return best;
}

// Any hit with t_min < t < t_max, in groups of four, leaving at the first
// group that holds one.
__device__ bool occluded(const float4* geo, int n_pad, V3 o, V3 d,
                         float t_min, float t_max) {
  for (int k0 = 0; k0 < n_pad; k0 += 4) {
    bool hit = false;
    if (any4<false>(geo, k0, o, d, t_min, t_max, &hit)) {
      hit = false;
      any4<true>(geo, k0, o, d, t_min, t_max, &hit);
    }
    if (hit) return true;
  }
  return false;
}

// Row `idx` of a table when the float names a row exactly, else null.
__device__ __forceinline__ const float* row_at(const float* table, int n_rows,
                                               int width, float idx) {
  if (idx >= 0.0f && idx < static_cast<float>(n_rows) &&
      idx == floorf(idx)) {
    return table + width * static_cast<int>(idx);
  }
  return nullptr;
}

__device__ __forceinline__ float bilerp(float c00, float c10, float c01,
                                        float c11, float fx, float fy) {
  const float top = c00 * (1.0f - fx) + c10 * fx;
  const float bot = c01 * (1.0f - fx) + c11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// Repeat-wrapped level-0 coordinates of one slot -> quad row index, fx, fy.
__device__ __forceinline__ float tex_coords(float off, float h, float w,
                                            float uvx, float uvy, float* fx,
                                            float* fy) {
  float x = uvx * w - 0.5f;
  float y = uvy * h - 0.5f;
  x = x - floorf(x / w) * w;
  y = y - floorf(y / h) * h;
  const float x0 = minnan(floorf(x), w - 1.0f);
  const float y0 = minnan(floorf(y), h - 1.0f);
  *fx = cl(x - x0, 0.0f, 1.0f);
  *fy = cl(y - y0, 0.0f, 1.0f);
  return off + y0 * w + x0;
}

struct Params {
  int width, height, n_pix, spp, max_bounces;
  long long n_items;  // n_pix * spp (pixel, sample) paths
  int n_tris, n_em, n_mats, n_rows;
  float eps, inv_w, inv_h;
  uint32_t seed0, seed1;
  int has_em, has_dir, textured;
};

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    fused_kernel(const float* __restrict__ cam_g,
                 const float* __restrict__ tri_g,
                 const float* __restrict__ em_g,
                 const float* __restrict__ mtex_g,
                 const float* __restrict__ quads_g, Params p,
                 float* __restrict__ hdr,
                 unsigned long long* __restrict__ count,
                 float* __restrict__ samples,
                 unsigned int* __restrict__ arrivals) {
  unsigned long long* next = count + 1;  // the work counter
  extern __shared__ float4 smem4[];
  float* cam = reinterpret_cast<float*>(smem4);
  float4* geo = smem4 + kCamW / 4;
  const int n_pad = (p.n_tris + 3) & ~3;
  float* tri = reinterpret_cast<float*>(geo + 3 * n_pad);
  float* em = tri + kTW * p.n_tris;
  float* mtex = em + kEW * p.n_em;
  float* quads = mtex + kMW * p.n_mats;
  for (int k = threadIdx.x; k < 18; k += blockDim.x) cam[k] = cam_g[k];
  for (int k = threadIdx.x; k < kTW * p.n_tris; k += blockDim.x)
    tri[k] = tri_g[k];
  for (int j = threadIdx.x; j < 3 * n_pad; j += blockDim.x) {
    const int k = j / 3;
    const float* r = tri_g + kTW * k + 3 * (j - 3 * k);
    geo[j] = k < p.n_tris ? make_float4(r[0], r[1], r[2], 0.0f)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int k = threadIdx.x; k < kEW * p.n_em; k += blockDim.x)
    em[k] = em_g[k];
  for (int k = threadIdx.x; k < kMW * p.n_mats; k += blockDim.x)
    mtex[k] = mtex_g[k];
  for (int k = threadIdx.x; k < kQW * p.n_rows; k += blockDim.x)
    quads[k] = quads_g[k];
  __syncthreads();

  // Persistent threads: a lane takes the next (pixel, sample) from the
  // frame's work counter whenever its path ends, so that no lane idles
  // while the others of its warp finish longer paths.  The lanes that need
  // work at once take it with one atomic (warp-aggregated).
  const unsigned lane = threadIdx.x & 31u;
  const V3 eye = load3(cam);
  const V3 rv = load3(cam + 3);
  const V3 uv = load3(cam + 6);
  const V3 fv = load3(cam + 9);
  const V3 dir_wi = load3(cam + 12);
  const V3 dir_rad = load3(cam + 15);
  const unsigned int n_shadow = (p.has_em ? 1u : 0u) + (p.has_dir ? 1u : 0u);
  const int per_bounce = p.has_em ? 6 : 3;
  const int bsdf_k = p.has_em ? 3 : 0;
  unsigned int cnt = 0;
  bool busy = false;
  long long item = 0;
  int pid = 0, bounce = 0;
  uint32_t us = 0, upid = 0;
  V3 o = eye, d = eye, tp = eye;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f, prev_pdf = 0.0f;
  while (true) {
    if (!busy) {
      const unsigned want = __activemask();
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (static_cast<int>(lane) == leader)
        base = atomicAdd(next, static_cast<unsigned long long>(__popc(want)));
      base = __shfl_sync(want, base, leader);
      item = static_cast<long long>(base) +
             __popc(want & ((1u << lane) - 1u));
      if (item >= p.n_items) break;
      pid = static_cast<int>(item / p.spp);
      const int s = static_cast<int>(item - (long long)pid * p.spp);
      us = static_cast<uint32_t>(s);
      upid = static_cast<uint32_t>(pid);
      const int py = pid / p.width;
      const float pxf = static_cast<float>(pid - py * p.width);
      const float pyf = static_cast<float>(py);
      const float jx = uniform(upid, p.seed0, p.seed1, us, 1u);
      const float jy = uniform(upid, p.seed0, p.seed1, us, 2u);
      const float ndx = 2.0f * (pxf + jx) * p.inv_w - 1.0f;
      const float ndy = 2.0f * (pyf + jy) * p.inv_h - 1.0f;
      d = normalize(v3(ndx * rv.x + ndy * uv.x + fv.x,
                       ndx * rv.y + ndy * uv.y + fv.y,
                       ndx * rv.z + ndy * uv.z + fv.z));
      o = eye;
      lr = lg = lb = 0.0f;
      tp = v3(1.0f, 1.0f, 1.0f);
      prev_pdf = 0.0f;
      bounce = 0;
      busy = true;
    }

    // One bounce of the path; a `break` ends the path.
    bool ends = true;
    do {
      cnt += 1;
      float tb, uw, vw;
      const int win = closest(geo, n_pad, o, d,
                              bounce == 0 ? 0.0f : p.eps, &tb, &uw, &vw);
      if (!(tb < kHalfBig)) break;           // miss: inactive from here
      const float* r = tri + kTW * win;
      const V3 ng = load3(r + 9);
      V3 bc = load3(r + 12);
      float met = r[15], rgh = r[16];
      const float spc = r[17];
      const V3 emis = load3(r + 18);
      const float pda = r[21];

      if (p.textured) {
        // factor x texture (glTF): albedo rgb from the base-color slot,
        // roughness = G / metallic = B of the metallic-roughness slot.
        const float wb = 1.0f - uw - vw;
        const float uvx = wb * r[22] + uw * r[24] + vw * r[26];
        const float uvy = wb * r[23] + uw * r[25] + vw * r[27];
        const float* meta = row_at(mtex, p.n_mats, kMW, r[28]);
        const float bco = meta ? meta[0] : -1.0f;
        const float bch = meta ? meta[1] : 1.0f;
        const float bcw = meta ? meta[2] : 1.0f;
        const float mro = meta ? meta[3] : -1.0f;
        const float mrh = meta ? meta[4] : 1.0f;
        const float mrw = meta ? meta[5] : 1.0f;
        float fxb, fyb, fxm, fym;
        const float idx_b = tex_coords(bco, bch, bcw, uvx, uvy, &fxb, &fyb);
        const float idx_m = tex_coords(mro, mrh, mrw, uvx, uvy, &fxm, &fym);
        const float* qb = row_at(quads, p.n_rows, kQW, idx_b);
        const float* qm = row_at(quads, p.n_rows, kQW, idx_m);
        if (bco >= 0.0f) {
          float c[3];
          for (int k = 0; k < 3; ++k) {
            c[k] = qb ? bilerp(qb[k], qb[4 + k], qb[8 + k], qb[12 + k], fxb,
                               fyb)
                      : bilerp(0.0f, 0.0f, 0.0f, 0.0f, fxb, fyb);
          }
          bc = v3(bc.x * c[0], bc.y * c[1], bc.z * c[2]);
        }
        if (mro >= 0.0f) {
          const float mr_g =
              qm ? bilerp(qm[1], qm[5], qm[9], qm[13], fxm, fym)
                 : bilerp(0.0f, 0.0f, 0.0f, 0.0f, fxm, fym);
          const float mr_b =
              qm ? bilerp(qm[2], qm[6], qm[10], qm[14], fxm, fym)
                 : bilerp(0.0f, 0.0f, 0.0f, 0.0f, fxm, fym);
          rgh = rgh * mr_g;
          met = met * mr_b;
        }
      }

      const V3 pos = add(o, scale(d, tb));
      const float dgn = dot(d, ng);
      const bool front = dgn < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      const V3 ngo = scale(ng, sgn);
      const V3 ns = ngo;  // flat_normals gate: shading normal = face normal

      if (p.has_em) {
        const float cos_l = mx(-sgn * dgn, 0.0f);
        const float tcl = mn(tb, F(1e6));
        const float dist2 = cl(tcl * tcl, F(1e-12), F(1e12));
        const float pdf_hit = pda * dist2 / mx(cos_l, F(1e-6));
        const float w_em =
            bounce == 0 ? 1.0f
                        : (prev_pdf > 0.0f ? power_mis(prev_pdf, pdf_hit)
                                           : 1.0f);
        const float emw = front ? w_em : 0.0f;
        lr = lr + tp.x * emis.x * emw;
        lg = lg + tp.y * emis.y * emw;
        lb = lb + tp.z * emis.z * emw;
      }

      if (bounce == p.max_bounces) break;

      V3 t, bt;
      onb(ns, &t, &bt);
      const V3 wo = v3(-dot(d, t), -dot(d, bt), -dot(d, ns));
      const V3 o_next = add(pos, scale(ngo, p.eps));
      const Bsdf bs = bsdf_consts(bc, met, rgh, spc);
      const uint32_t site0 =
          static_cast<uint32_t>(3 + per_bounce * bounce);

      // --- NEE ------------------------------------------------------
      cnt += n_shadow;
      if (p.has_em) {
        const float u_sel = uniform(upid, p.seed0, p.seed1, us, site0);
        const float u_a = uniform(upid, p.seed0, p.seed1, us, site0 + 1u);
        const float u_b = uniform(upid, p.seed0, p.seed1, us, site0 + 2u);
        // Smallest e with cdf[e] >= u (one emitter: row 0); a u above
        // every cdf selects nothing and leaves a zero row.
        const float* erow = em;
        if (p.n_em != 1) {
          int pick = 0;
          for (int e = 0; e < p.n_em; ++e) pick += em[kEW * e + 13] < u_sel;
          erow = pick < p.n_em ? em + kEW * pick : nullptr;
        }
        float e_[13];
        for (int k = 0; k < 13; ++k) e_[k] = erow ? erow[k] : 0.0f;
        const V3 ev0 = v3(e_[0], e_[1], e_[2]);
        const V3 ee1 = v3(e_[3], e_[4], e_[5]);
        const V3 ee2 = v3(e_[6], e_[7], e_[8]);
        const float epda = e_[9];
        const V3 erad = v3(e_[10], e_[11], e_[12]);

        const float su = sqrtf(cl(u_a, 0.0f, 1.0f));
        const float b1 = 1.0f - su;
        const float b2 = u_b * su;
        const V3 lp = add(ev0, add(scale(ee1, b1), scale(ee2, b2)));
        const V3 lng = normalize(cross(ee1, ee2));
        const V3 tol = sub(lp, pos);
        const float dist2 = mx(dot(tol, tol), F(1e-12));
        const float dist = sqrtf(dist2);
        const V3 wi_w = scale(tol, 1.0f / dist);
        const float cos_le = -dot(lng, wi_w);
        const float pdf_sa = epda * dist2 / mx(cos_le, F(1e-6));
        const bool lvalid = cos_le > F(1e-6) && epda > 0.0f;

        const V3 wi = v3(dot(wi_w, t), dot(wi_w, bt), dot(wi_w, ns));
        float pdf_b;
        const V3 fb = eval_bsdf(wo, wi, bs, &pdf_b);
        const float cos_i = mx(wi.z, 0.0f);
        if (lvalid && cos_i > F(1e-7) && pdf_sa > 0.0f &&
            !occluded(geo, n_pad, o_next, wi_w, p.eps,
                      dist * kShadowScale)) {
          const float w = power_mis(pdf_sa, pdf_b);
          const float k = cos_i * w / mx(pdf_sa, F(1e-12));
          lr = lr + tp.x * fb.x * erad.x * k;
          lg = lg + tp.y * fb.y * erad.y * k;
          lb = lb + tp.z * fb.z * erad.z * k;
        }
      }

      if (p.has_dir) {
        // Delta light: wi = -direction, radiance const, no MIS.
        const V3 wi = v3(dot(dir_wi, t), dot(dir_wi, bt), dot(dir_wi, ns));
        float pdf_unused;
        const V3 fd = eval_bsdf(wo, wi, bs, &pdf_unused);
        const float cos_i = mx(wi.z, 0.0f);
        if (cos_i > F(1e-7) &&
            !occluded(geo, n_pad, o_next, dir_wi, p.eps, kDirTMax)) {
          lr = lr + tp.x * fd.x * dir_rad.x * cos_i;
          lg = lg + tp.y * fd.y * dir_rad.y * cos_i;
          lb = lb + tp.z * fd.z * dir_rad.z * cos_i;
        }
      }

      // --- BSDF sampling ---------------------------------------------
      const uint32_t sb = site0 + static_cast<uint32_t>(bsdf_k);
      const float u_l = uniform(upid, p.seed0, p.seed1, us, sb);
      const float u_1 = uniform(upid, p.seed0, p.seed1, us, sb + 1u);
      const float u_2 = uniform(upid, p.seed0, p.seed1, us, sb + 2u);
      V3 fs;
      float pdf;
      const V3 wi = sample_bsdf(wo, u_l, u_1, u_2, bs, &fs, &pdf);
      const float cos_i = mx(wi.z, 0.0f);
      const bool ok = pdf > F(1e-9) && cos_i > 0.0f;
      const float wgt = ok ? cos_i / mx(pdf, F(1e-20)) : 0.0f;
      tp = v3(tp.x * fs.x * wgt, tp.y * fs.y * wgt, tp.z * fs.z * wgt);
      const float tmax_c = maxnan(tp.x, maxnan(tp.y, tp.z));
      if (!(ok && tmax_c > 0.0f)) break;    // absorbed: inactive
      d = normalize(add(add(scale(t, wi.x), scale(bt, wi.y)),
                        scale(ns, wi.z)));
      o = o_next;
      prev_pdf = pdf;
      ++bounce;
      ends = false;
    } while (false);
    if (!ends) continue;
    busy = false;
    // The sample's radiance to the scratch; the pixel's last sample to
    // finish sums them in sample order, ((0 + L0) + L1) + ..., as the
    // plain version does.  Each thread fences its stores before it
    // counts itself in, and the last one fences before it reads
    // (through L2, which every SM shares).
    float* mine = samples + 3 * item;
    mine[0] = lr;
    mine[1] = lg;
    mine[2] = lb;
    __threadfence();
    if (atomicAdd(arrivals + pid, 1u) == static_cast<unsigned>(p.spp - 1)) {
      __threadfence();
      const float* all = samples + 3 * (long long)pid * p.spp;
      float ar = 0.0f, ag = 0.0f, ab = 0.0f;
      for (int q = 0; q < p.spp; ++q) {
        ar = ar + __ldcg(all + 3 * q);
        ag = ag + __ldcg(all + 3 * q + 1);
        ab = ab + __ldcg(all + 3 * q + 2);
      }
      hdr[3 * pid + 0] = ar;
      hdr[3 * pid + 1] = ag;
      hdr[3 * pid + 2] = ab;
    }
  }

  // Exact ray-query count: warp shuffles, then one atomic per block.
  __shared__ unsigned long long warp_sum[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    atomicAdd(count, total);
  }
}

}  // namespace

// count_out: int64[2] zeroed, the ray-query count and the work counter;
// samples: f32[n_pix * spp * 3] scratch; arrivals: uint32[n_pix] zeroed.
extern "C" int pbr_fused_render(const float* cam, const float* tri,
                                int n_tris, const float* em, int n_em,
                                const float* mtex, int n_mats,
                                const float* quads, int n_rows, int width,
                                int height, int spp, int max_bounces,
                                float eps, float inv_w, float inv_h,
                                unsigned int seed0, unsigned int seed1,
                                int has_em, int has_dir, int textured,
                                float* hdr_out, long long* count_out,
                                float* samples, unsigned int* arrivals,
                                void* stream) {
  Params p;
  p.width = width;
  p.height = height;
  p.n_pix = width * height;
  p.n_items = (long long)p.n_pix * spp;
  p.spp = spp;
  p.max_bounces = max_bounces;
  p.n_tris = n_tris;
  p.n_em = n_em;
  p.n_mats = n_mats;
  p.n_rows = n_rows;
  p.eps = eps;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  p.seed0 = seed0;
  p.seed1 = seed1;
  p.has_em = has_em;
  p.has_dir = has_dir;
  p.textured = textured;
  if (p.n_items <= 0) return 0;
  const size_t smem = sizeof(float) *
                      (size_t(kCamW) + size_t(kGW) * ((n_tris + 3) & ~3) +
                       size_t(kTW) * n_tris +
                       size_t(kEW) * n_em + size_t(kMW) * n_mats +
                       size_t(kQW) * n_rows);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  // As many blocks as the card holds at once, and no more than the
  // frame's (pixel, sample) threads need: the threads are persistent.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  long long blocks = (p.n_items + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  fused_kernel<<<unsigned(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      cam, tri, em, mtex, quads, p, hdr_out,
      reinterpret_cast<unsigned long long*>(count_out), samples, arrivals);
  return int(cudaGetLastError());
}
