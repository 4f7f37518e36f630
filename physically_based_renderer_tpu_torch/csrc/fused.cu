// Fused whole-frame megakernel (K4): camera rays, the whole bounce loop
// (closest hit, emitter-hit MIS, NEE with shadow rays, GGX/Lambert BSDF
// sampling), the spp sum and the ray-query count in one launch.
//
// Replaces: the reference package's ops/fused.py::_make_kernel.kernel
// (:402), launched by render_fused_stats (:714-756).  The TPU kernel renders
// a [8, 512] tile of rays per grid step with every per-ray scalar a vector
// register and the scene tables in SMEM; here one thread owns one pixel and
// loops over its samples and bounces in registers, and each block stages
// the tables into shared memory once.
//
// What bounds it on the H100: arithmetic and divergence.  Every bounce is a
// brute-force Moller-Trumbore over all triangles (~30 f32 operations each,
// read from shared memory as a broadcast) plus one shadow pass per light
// family; a 512x512, 4 spp, 4-bounce Cornell frame makes ~3.6M ray queries
// of 32 triangles (~4 GFLOP of intersection tests) and writes only the 3 MB
// image.  Threads of a
// warp leave the bounce loop at different bounces (misses, absorbed paths),
// so lanes idle towards the end of a sample; path compaction is later work.
//
// Design:
//  * one thread per pixel, 128 threads per block, ragged tail masked by the
//    pixel count; the block stages cam | tri | emitter | texture meta | quad
//    tables (20 + 32T + 14E + 6M + 16R floats) into dynamic shared memory,
//    ~55.6 KB at the reference's limits (340 triangles, 32 emitters, 160
//    texel rows), with the opt-in above 48 KB (cudaFuncSetAttribute);
//  * the murmur3 counter RNG in uint32 arithmetic, keyed by (frame seeds,
//    pixel id, sample, draw site) exactly as the reference; the draw site
//    is 1, 2 for the jitter and 3 + 6b + k (with area emitters) or
//    3 + 3b + k (without) in bounce b;
//  * a lane leaves the bounce loop when it stops being active: from then on
//    the reference adds only zeros for it;
//  * each thread writes its own pixel's HDR sum (no atomics on the image);
//    the ray-query count is reduced per block (warp shuffles, then shared
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

namespace {

constexpr int kThreads = 128;
constexpr int kCamW = 20;  // 18 used, padded
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

// --- tracing over the shared-memory triangle table ------------------------

__device__ __forceinline__ bool mt(const float* r, V3 o, V3 d, float t_min,
                                   float* tt, float* u, float* v) {
  const V3 v0 = load3(r);
  const V3 e1 = load3(r + 3);
  const V3 e2 = load3(r + 6);
  const V3 p = cross(d, e2);
  const float det = dot(p, e1);
  const bool nonzero = fabsf(det) > F(1e-9);
  const float inv = nonzero ? 1.0f / det : 0.0f;
  const V3 tv = sub(o, v0);
  *u = dot(tv, p) * inv;
  const V3 q = cross(tv, e1);
  *v = dot(d, q) * inv;
  *tt = dot(e2, q) * inv;
  return nonzero && *u >= 0.0f && *v >= 0.0f && *u + *v <= 1.0f &&
         *tt > t_min;
}

// Closest hit: a hit replaces the best only at a strictly smaller t, so
// ties go to the lowest triangle index; -1 and kBig on a miss.
__device__ int closest(const float* tri, int n_tris, V3 o, V3 d, float t_min,
                       float* t_best, float* u_best, float* v_best) {
  float tb = kBig, ub = 0.0f, vb = 0.0f;
  int best = -1;
  for (int k = 0; k < n_tris; ++k) {
    float tt, u, v;
    if (mt(tri + kTW * k, o, d, t_min, &tt, &u, &v) && tt < tb) {
      tb = tt;
      ub = u;
      vb = v;
      best = k;
    }
  }
  *t_best = tb;
  *u_best = ub;
  *v_best = vb;
  return best;
}

__device__ bool occluded(const float* tri, int n_tris, V3 o, V3 d,
                         float t_min, float t_max) {
  for (int k = 0; k < n_tris; ++k) {
    float tt, u, v;
    if (mt(tri + kTW * k, o, d, t_min, &tt, &u, &v) && tt < t_max) {
      return true;
    }
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
  int n_tris, n_em, n_mats, n_rows;
  float eps, inv_w, inv_h;
  uint32_t seed0, seed1;
  int has_em, has_dir, textured;
};

__global__ void __launch_bounds__(kThreads)
    fused_kernel(const float* __restrict__ cam_g,
                 const float* __restrict__ tri_g,
                 const float* __restrict__ em_g,
                 const float* __restrict__ mtex_g,
                 const float* __restrict__ quads_g, Params p,
                 float* __restrict__ hdr,
                 unsigned long long* __restrict__ count) {
  extern __shared__ float smem[];
  float* cam = smem;
  float* tri = cam + kCamW;
  float* em = tri + kTW * p.n_tris;
  float* mtex = em + kEW * p.n_em;
  float* quads = mtex + kMW * p.n_mats;
  for (int k = threadIdx.x; k < 18; k += blockDim.x) cam[k] = cam_g[k];
  for (int k = threadIdx.x; k < kTW * p.n_tris; k += blockDim.x)
    tri[k] = tri_g[k];
  for (int k = threadIdx.x; k < kEW * p.n_em; k += blockDim.x)
    em[k] = em_g[k];
  for (int k = threadIdx.x; k < kMW * p.n_mats; k += blockDim.x)
    mtex[k] = mtex_g[k];
  for (int k = threadIdx.x; k < kQW * p.n_rows; k += blockDim.x)
    quads[k] = quads_g[k];
  __syncthreads();

  const int pid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int cnt = 0;
  if (pid < p.n_pix) {
    const V3 eye = load3(cam);
    const V3 rv = load3(cam + 3);
    const V3 uv = load3(cam + 6);
    const V3 fv = load3(cam + 9);
    const V3 dir_wi = load3(cam + 12);
    const V3 dir_rad = load3(cam + 15);
    const unsigned int n_shadow = (p.has_em ? 1u : 0u) + (p.has_dir ? 1u : 0u);
    const int per_bounce = p.has_em ? 6 : 3;
    const int bsdf_k = p.has_em ? 3 : 0;
    const uint32_t upid = static_cast<uint32_t>(pid);
    const int py = pid / p.width;
    const float pxf = static_cast<float>(pid - py * p.width);
    const float pyf = static_cast<float>(py);

    float ar = 0.0f, ag = 0.0f, ab = 0.0f;
    for (int s = 0; s < p.spp; ++s) {
      const uint32_t us = static_cast<uint32_t>(s);
      const float jx = uniform(upid, p.seed0, p.seed1, us, 1u);
      const float jy = uniform(upid, p.seed0, p.seed1, us, 2u);
      const float ndx = 2.0f * (pxf + jx) * p.inv_w - 1.0f;
      const float ndy = 2.0f * (pyf + jy) * p.inv_h - 1.0f;
      V3 d = normalize(v3(ndx * rv.x + ndy * uv.x + fv.x,
                          ndx * rv.y + ndy * uv.y + fv.y,
                          ndx * rv.z + ndy * uv.z + fv.z));
      V3 o = eye;
      float lr = 0.0f, lg = 0.0f, lb = 0.0f;
      V3 tp = v3(1.0f, 1.0f, 1.0f);
      float prev_pdf = 0.0f;

      for (int bounce = 0; bounce <= p.max_bounces; ++bounce) {
        cnt += 1;
        float tb, uw, vw;
        const int win = closest(tri, p.n_tris, o, d,
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
              !occluded(tri, p.n_tris, o_next, wi_w, p.eps,
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
              !occluded(tri, p.n_tris, o_next, dir_wi, p.eps, kDirTMax)) {
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
      }
      ar = ar + lr;
      ag = ag + lg;
      ab = ab + lb;
    }
    hdr[3 * pid + 0] = ar;
    hdr[3 * pid + 1] = ag;
    hdr[3 * pid + 2] = ab;
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

extern "C" int pbr_fused_render(const float* cam, const float* tri,
                                int n_tris, const float* em, int n_em,
                                const float* mtex, int n_mats,
                                const float* quads, int n_rows, int width,
                                int height, int spp, int max_bounces,
                                float eps, float inv_w, float inv_h,
                                unsigned int seed0, unsigned int seed1,
                                int has_em, int has_dir, int textured,
                                float* hdr_out, long long* count_out,
                                void* stream) {
  Params p;
  p.width = width;
  p.height = height;
  p.n_pix = width * height;
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
  if (p.n_pix <= 0) return 0;
  const size_t smem = sizeof(float) *
                      (size_t(kCamW) + size_t(kTW) * n_tris +
                       size_t(kEW) * n_em + size_t(kMW) * n_mats +
                       size_t(kQW) * n_rows);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int blocks = (p.n_pix + kThreads - 1) / kThreads;
  fused_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, tri, em, mtex, quads, p, hdr_out,
      reinterpret_cast<unsigned long long*>(count_out));
  return int(cudaGetLastError());
}
