// The phase-1 kernels' per-pixel body for Hopper (sm_90a): the forward
// (megakernel_fwd.cu) and the backward kernels that replay it
// (megakernel_bwd.cu, megabwd_hand.cu, through megakernel_adjoint.cuh).
//
// One body traces a pixel's path for all of them (sweep_forward), so every
// kernel picks the same winners, the same sphere roots and the same occlusion
// bits, and a backward kernel that evaluates the forward again gets the
// forward's numbers bit for bit.  The plain PyTorch version
// (megakernel.py:tile_color_reference) rounds alike:
// * every a * b + c of the forward is written out as __fmaf_rn, in the order
//   each helper states, and the plain version computes the same fused
//   operation exactly (megakernel.py:_fma);
// * every other product, sum, division and sqrtf rounds on its own: the
//   build keeps -fmad=false, so nvcc contracts nothing itself, wherever the
//   body is inlined;
// * the specular power is exp2f(shin * log2f(x)) (p1_pow), as the plain
//   version's torch.exp2(shin * torch.log2(x)).
// The traversal kernels keep the unfused helpers of megakernel_common.cuh
// (tri_t, sph_t, raygen, dot, normalize); the p1_ helpers here are the
// phase-1 family's own.
//
// Early rejections that keep every bit (tests/test_torch_phase1_math.py):
// * triangle: t = -no / ndd > T_MIN > 0 needs no and ndd of opposite signs,
//   so !(no * ndd < 0) misses before the division.  Where the product
//   underflows to zero, |no ndd| < 2^-149 and |ndd| >= 1e-9, so
//   |t| < 2^-149 / 1e-18, far below T_MIN; a NaN misses on both sides.  A t
//   outside (T_MIN, min(T_MAX, tmax)) misses before u and v: the caller
//   keeps a hit only below tmax (the best so far, or the light's distance).
// * sphere: b > 0 and c > 0 put both roots below zero: disc <= fl(b b) and
//   sqrtf(fl(b b)) == b where nothing underflows (a root that an underflow
//   leaves positive is below 2^-74), so the sphere misses before the sqrtf.
// * any-hit: the spheres before the triangles (a floor point's occluders are
//   the spheres); the answer is the same in any order.
//
// Records: occ[d] bit l is set when light l is blocked from the point the
// pixel shades at depth d.  A path with no shaded point at depth d (it missed,
// or ended earlier) has every light bit set when shadows are on: that is what
// the TPU kernel records for a miss, whose light distance overflows to inf so
// that every shadow test counts as blocked.

#pragma once

#include "megakernel_common.cuh"

namespace tpurt {

constexpr int MAX_LIGHTS = 31;  // one occlusion bit a light in an int32 record
constexpr int NGLOB_MAX = NGLOB_BASE + 6 * MAX_LIGHTS;

// a.b = fma(a.z, b.z, fma(a.y, b.y, a.x * b.x))
__device__ __forceinline__ float p1_dot(V3 a, V3 b) {
  return __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, a.x * b.x));
}
// value of form (a | a.w) at point o: fma(a.z, o.z, fma(a.y, o.y, fma(a.x, o.x, a.w)))
__device__ __forceinline__ float p1_form_o(float4 a, V3 o) {
  return __fmaf_rn(a.z, o.z, __fmaf_rn(a.y, o.y, __fmaf_rn(a.x, o.x, a.w)));
}
// value of form a at direction d: p1_dot(a.xyz, d)
__device__ __forceinline__ float p1_form_d(float4 a, V3 d) { return p1_dot(xyz(a), d); }
// a + b s, each component one fma(b, s, a)
__device__ __forceinline__ V3 p1_axpy(V3 a, V3 b, float s) {
  return {__fmaf_rn(b.x, s, a.x), __fmaf_rn(b.y, s, a.y), __fmaf_rn(b.z, s, a.z)};
}
// a rsqrt(a.a + eps), the squares summed as fma(a.z, a.z, fma(a.y, a.y, fma(a.x, a.x, eps)))
__device__ __forceinline__ V3 p1_normalize(V3 a) {
  return scale(a, rsqrtf(__fmaf_rn(a.z, a.z, __fmaf_rn(a.y, a.y, __fmaf_rn(a.x, a.x,
                                                                           NORMALIZE_EPS)))));
}
// d - n (2 d.n) = p1_axpy(d, n, -2 d.n): the doubling is exact
__device__ __forceinline__ V3 p1_reflect(V3 d, V3 n) { return p1_axpy(d, n, -2.0f * p1_dot(d, n)); }
// n0 w + n1 u + n2 v = fma(n0, w, fma(n1, u, n2 v))
__device__ __forceinline__ V3 p1_interp(V3 n0, V3 n1, V3 n2, float w, float u, float v) {
  return {__fmaf_rn(n0.x, w, __fmaf_rn(n1.x, u, n2.x * v)),
          __fmaf_rn(n0.y, w, __fmaf_rn(n1.y, u, n2.y * v)),
          __fmaf_rn(n0.z, w, __fmaf_rn(n1.z, u, n2.z * v))};
}
// x^y for the specular term, x in (0, 1]
__device__ __forceinline__ float p1_pow(float x, float y) { return exp2f(y * log2f(x)); }

// Where the body reads the globals (camera, ambient, lights): a copy in the
// block's shared memory (megakernel_fwd), or device memory through the
// read-only path (the backward kernels, whose shared memory holds tables).
struct SharedGlobals {
  const float* g;
  __device__ __forceinline__ float at(int k) const { return g[k]; }
};
struct DeviceGlobals {
  const float* __restrict__ g;
  __device__ __forceinline__ float at(int k) const { return __ldg(g + k); }
};
template <class G>
__device__ __forceinline__ V3 at3(const G& g, int k) {
  return {g.at(k), g.at(k + 1), g.at(k + 2)};
}

// t of triangle i in (T_MIN, min(T_MAX, tmax)), else T_NONE; u, v at that t
// (set only for a hit)
__device__ __forceinline__ float p1_tri_t(const Scene& s, int i, V3 o, V3 d, float tmax, float& u,
                                          float& v) {
  const float4 fn = __ldg(s.tri + 3 * i);
  const float no = p1_form_o(fn, o);
  const float ndd = p1_form_d(fn, d);
  if (!(no * ndd < 0.0f) || !(fabsf(ndd) >= MT_DET_EPS)) return T_NONE;
  const float t = -no / ndd;
  if (!(t > T_MIN && t < T_MAX && t < tmax)) return T_NONE;
  const float4 fu = __ldg(s.tri + 3 * i + 1);
  const float4 fv = __ldg(s.tri + 3 * i + 2);
  u = __fmaf_rn(t, p1_form_d(fu, d), p1_form_o(fu, o));
  v = __fmaf_rn(t, p1_form_d(fv, d), p1_form_o(fv, o));
  return (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) ? t : T_NONE;
}

// b and c of the quadratic t^2 + 2 b t + c of the sphere with forms fc, fd,
// from the ray's o.o and o.d; its discriminant b b - c = fma(b, b, -c)
struct SphereTerms {
  float b, cterm;
};
__device__ __forceinline__ SphereTerms p1_sph_terms(float4 fc, float4 fd, V3 o, V3 d, float oo,
                                                    float od) {
  return {od - p1_form_d(fd, d), oo + p1_form_o(fc, o)};
}
__device__ __forceinline__ float p1_disc(SphereTerms q) { return __fmaf_rn(q.b, q.b, -q.cterm); }

// nearest root of sphere j in (T_MIN, T_MAX), else T_NONE; first says that the
// root is -b - sqrt(disc), the selector the backward uses in place of a float
// comparison
__device__ __forceinline__ float p1_sph_t(const Scene& s, int j, V3 o, V3 d, float oo, float od,
                                          bool& first) {
  const SphereTerms q = p1_sph_terms(__ldg(s.sph + 2 * j), __ldg(s.sph + 2 * j + 1), o, d, oo, od);
  first = false;
  if (q.b > 0.0f && q.cterm > 0.0f) return T_NONE;
  const float disc = p1_disc(q);
  if (!(disc > 0.0f)) return T_NONE;
  const float sq = sqrtf(disc);
  const float t0 = -q.b - sq;
  first = t0 > T_MIN && t0 < T_MAX;
  if (first) return t0;
  const float t1 = -q.b + sq;
  return (t1 > T_MIN && t1 < T_MAX) ? t1 : T_NONE;
}

// b and disc of the quadratic t^2 + 2 b t + c of the sphere with forms fc, fd
// and attrs row a, written the way that rounds less at this ray: from the
// forms (p1_sph_terms), or from o - c: oc = o - c, b = oc.d,
// l = oc - b d = p1_axpy(oc, d, -b), disc = fma(r, r, -l.l).  The forms'
// c = o.o + fc(o) cancels to a few ulps of its summands, |o|^2 and |2 c.o|
// (about 1e-4 at 12 units from the origin, which moves the root of a sphere
// of radius 0.2 by about 1e-3 and its derivatives by a few %); l.l rounds
// to a few ulps of r (r + 4 |oc|), which is worse for a sphere as large as
// its distance (a ground sphere of radius 1000, whose c.c - r^2 is exactly
// 0).  The bounds are compared in plain float products and sums.
constexpr int A_RADIUS = 33;  // pack.py:A_RADIUS
struct SphereQuadratic {
  float b, disc;
};
__device__ __forceinline__ SphereQuadratic p1_sph_quadratic(float4 fc, float4 fd, const float* a,
                                                            V3 o, V3 d) {
  const float oo = p1_dot(o, o);
  const SphereTerms q = p1_sph_terms(fc, fd, o, d, oo, p1_dot(o, d));
  const float err_f = q.b * q.b + oo + fabsf(fc.x * o.x) + fabsf(fc.y * o.y) +
                      fabsf(fc.z * o.z) + fabsf(fc.w);
  const V3 oc = sub(o, ld3(a + A_CENTER));
  const float r = __ldg(a + A_RADIUS);
  const float err_l = r * (r + 4.0f * (fabsf(oc.x) + fabsf(oc.y) + fabsf(oc.z)));
  if (!(err_l < err_f)) return {q.b, p1_disc(q)};
  const float b = p1_dot(oc, d);
  const V3 l = p1_axpy(oc, d, -b);
  return {b, __fmaf_rn(r, r, -p1_dot(l, l))};
}
// the winning sphere j's t: -b - sqrt(disc) where first, else -b + sqrt(disc),
// of p1_sph_quadratic (a disc below 0 taken as 0).  The forms still decide
// which primitive wins, which root, and every any-hit test; the backward
// kernels differentiate the root at the same b and disc.
__device__ __forceinline__ float p1_sph_root(const Scene& s, int j, V3 o, V3 d, bool first) {
  const SphereQuadratic q =
      p1_sph_quadratic(__ldg(s.sph + 2 * j), __ldg(s.sph + 2 * j + 1),
                       s.attrs + static_cast<long long>(s.n_tris + j) * ACOLS, o, d);
  const float sq = sqrtf(q.disc > 0.0f ? q.disc : 0.0f);
  return first ? -q.b - sq : -q.b + sq;
}

struct Hit {
  float t, u, v;
  int idx;     // row of attrs: triangle i, or n_tris + sphere j; -1 for a miss
  bool first;  // a sphere's nearer root won
};

// triangles before spheres, strict <: the lowest index wins a tie; a
// winning sphere's t is p1_sph_root's
__device__ inline Hit closest(const Scene& s, V3 o, V3 d) {
  Hit h{T_NONE, 0.0f, 0.0f, -1, false};
  for (int i = 0; i < s.n_tris; ++i) {
    float u, v;
    const float t = p1_tri_t(s, i, o, d, h.t, u, v);
    if (t < h.t) h = {t, u, v, i, false};
  }
  const float oo = p1_dot(o, o);
  const float od = p1_dot(o, d);
  for (int j = 0; j < s.n_sph; ++j) {
    bool first;
    const float t = p1_sph_t(s, j, o, d, oo, od, first);
    if (t < h.t) h = {t, 0.0f, 0.0f, s.n_tris + j, first};
  }
  if (h.idx >= s.n_tris) h.t = p1_sph_root(s, h.idx - s.n_tris, o, d, h.first);
  return h;
}

// any primitive at t < tmax along the ray; spheres first
__device__ inline bool occluded(const Scene& s, V3 o, V3 d, float tmax) {
  const float oo = p1_dot(o, o);
  const float od = p1_dot(o, d);
  for (int j = 0; j < s.n_sph; ++j) {
    bool first;
    if (p1_sph_t(s, j, o, d, oo, od, first) < tmax) return true;
  }
  for (int i = 0; i < s.n_tris; ++i) {
    float u, v;
    if (p1_tri_t(s, i, o, d, tmax, u, v) < tmax) return true;
  }
  return false;
}

// camera ray of flat pixel pix: o = eye, d = p1_normalize(graw),
// graw = fma(right, sx, fma(up, sy, fwd))
template <class G>
__device__ __forceinline__ CameraRay p1_raygen(const G& g, const Frame& f, int pix) {
  const float row = static_cast<float>(pix / f.width);
  const float col = static_cast<float>(pix % f.width);
  CameraRay r;
  r.sx = (2.0f * (col + 0.5f) / static_cast<float>(f.width) - 1.0f) * f.aspect;
  r.sy = 1.0f - 2.0f * (row + 0.5f) / static_cast<float>(f.height);
  r.o = at3(g, 0);
  r.graw = p1_axpy(p1_axpy(at3(g, 3), at3(g, 9), r.sy), at3(g, 6), r.sx);
  r.d = p1_normalize(r.graw);
  return r;
}

// shading normal at hit h of ray (o, d): interpolated and two-sided on a
// triangle, radial and not flipped on a sphere
__device__ __forceinline__ V3 surface_normal(const Scene& s, const float* a, const Hit& h, V3 p,
                                             V3 d) {
  if (h.idx < s.n_tris) {
    const V3 ni = p1_normalize(p1_interp(ld3(a + A_N0), ld3(a + A_N1), ld3(a + A_N2),
                                         1.0f - h.u - h.v, h.u, h.v));
    return p1_dot(ni, d) > 0.0f ? neg(ni) : ni;
  }
  return p1_normalize(sub(p, ld3(a + A_CENTER)));
}

// One light's forward terms at a shaded point p with normal n seen along
// view = -d: what the forward shades with, and what the reverse sweep
// (megakernel_adjoint.cuh) evaluates again
struct LightTerms {
  V3 to_l, ldir, refl_l;
  float dist2, dist, inv, raw_nl, ndotl, raw_rv, rdotv, safe_rv, spec;
  bool specmask;
};
__device__ __forceinline__ LightTerms light_terms(V3 lpos, V3 p, V3 n, V3 view, float shin) {
  LightTerms l;
  l.to_l = sub(lpos, p);
  l.dist2 = p1_dot(l.to_l, l.to_l);
  l.dist = sqrtf(l.dist2);
  l.inv = 1.0f / fmaxf(l.dist, 1e-20f);
  l.ldir = scale(l.to_l, l.inv);
  l.raw_nl = p1_dot(n, l.ldir);
  l.ndotl = fmaxf(l.raw_nl, 0.0f);
  l.refl_l = p1_reflect(neg(l.ldir), n);
  l.raw_rv = p1_dot(l.refl_l, view);
  l.rdotv = fmaxf(l.raw_rv, 0.0f);
  l.safe_rv = l.rdotv > 0.0f ? l.rdotv : 1.0f;
  l.specmask = l.ndotl > 0.0f && l.rdotv > 0.0f;
  l.spec = l.specmask ? p1_pow(l.safe_rv, shin) : 0.0f;
  return l;
}
// one channel's Phong sum kd ndotl + ks spec = fma(kd, ndotl, ks spec)
__device__ __forceinline__ float p1_phong(float kd, float ks, const LightTerms& l) {
  return __fmaf_rn(kd, l.ndotl, ks * l.spec);
}

// what a backward kernel keeps of one depth of a path: 11 words, an odd
// count, so that the 32 threads of a warp that read word w of their own
// residuals, [depth][thread] in shared memory, hit 32 distinct banks
struct Residual {
  V3 o, d;     // the ray that entered the depth
  float thr;   // throughput on entry
  float t, u, v;
  int code;    // 2 idx + first
  // winner's attrs row, -1 where the path missed
  __device__ __forceinline__ int idx() const { return code >> 1; }
  // sphere root selector
  __device__ __forceinline__ bool first() const { return code & 1; }
};
static_assert(sizeof(Residual) == 44, "a Residual is 11 words");

// Trace one pixel's path.  Adds the path's radiance into acc (before the
// clip; acc = fma(thr, colour, acc) a depth) and returns the number of depths
// visited, a final miss included.  The globals come through g.
//   kRecorded: visibility comes from occ[k * stride] and no shadow ray is
//     traced; otherwise shadow rays are traced and occ[k * stride] is written
//     for every depth up to max_depth.
//   kKeep: res[k * THREADS] is filled for every visited depth (a thread's
//     residuals in a block's shared memory, [depth][thread]).
template <bool kRecorded, bool kKeep, class G>
__device__ __forceinline__ int sweep_forward(const Scene& s, const G& g, V3 o, V3 d,
                                             int max_depth, int shadows, int* occ,
                                             long long stride, Residual* res, float& acc0,
                                             float& acc1, float& acc2) {
  const V3 ambient = at3(g, 12);
  const int L = s.n_lights;
  const int full = shadows ? static_cast<int>((1u << L) - 1u) : 0;
  float thr = 1.0f;
  int depth = 0;
  int visited = 0;
  for (; depth <= max_depth; ++depth) {
    const Hit h = closest(s, o, d);
    visited = depth + 1;
    if (kKeep) res[depth * THREADS] = {o, d, thr, h.t, h.u, h.v, 2 * h.idx + (h.first ? 1 : 0)};
    if (!(h.t < T_MAX)) {  // miss: background, and the path ends
      acc0 = __fmaf_rn(thr, BG0, acc0);
      acc1 = __fmaf_rn(thr, BG1, acc1);
      acc2 = __fmaf_rn(thr, BG2, acc2);
      break;
    }
    const V3 p = p1_axpy(o, d, h.t);
    const float* a = s.attrs + static_cast<long long>(h.idx) * ACOLS;
    const V3 n = surface_normal(s, a, h, p, d);
    const V3 ka = ld3(a + A_KA), kd = ld3(a + A_KD), ks = ld3(a + A_KS);
    const float shin = __ldg(a + A_SHIN);
    const float refl = __ldg(a + A_REFL);

    float c0 = ka.x * ambient.x, c1 = ka.y * ambient.y, c2 = ka.z * ambient.z;
    const V3 view = neg(d);
    const V3 p_off = p1_axpy(p, n, RAY_OFFSET_EPS);
    const int rec = kRecorded ? occ[depth * stride] : 0;
    int bits = 0;
    for (int li = 0; li < L; ++li) {
      const V3 lcol = at3(g, NGLOB_BASE + 3 * L + 3 * li);
      const LightTerms l = light_terms(at3(g, NGLOB_BASE + 3 * li), p, n, view, shin);
      float vis = 1.0f;
      if (kRecorded) {
        if (shadows && ((rec >> li) & 1)) vis = 0.0f;
      } else if (shadows && occluded(s, p_off, l.ldir, l.dist - RAY_OFFSET_EPS)) {
        bits |= 1 << li;
        vis = 0.0f;
      }
      c0 = __fmaf_rn(vis * lcol.x, p1_phong(kd.x, ks.x, l), c0);
      c1 = __fmaf_rn(vis * lcol.y, p1_phong(kd.y, ks.y, l), c1);
      c2 = __fmaf_rn(vis * lcol.z, p1_phong(kd.z, ks.z, l), c2);
    }
    if (!kRecorded) occ[depth * stride] = bits;
    acc0 = __fmaf_rn(thr, c0, acc0);
    acc1 = __fmaf_rn(thr, c1, acc1);
    acc2 = __fmaf_rn(thr, c2, acc2);
    thr = thr * refl;
    if (!(refl > 0.0f)) {
      ++depth;
      break;
    }
    o = p_off;
    d = p1_reflect(d, n);
  }
  if (!kRecorded) {
    // the miss's own depth and every later one: no shaded point
    for (int k = depth; k <= max_depth; ++k) occ[k * stride] = full;
  }
  return visited;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

}  // namespace tpurt
