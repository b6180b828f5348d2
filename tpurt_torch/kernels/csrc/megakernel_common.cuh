// Device code shared by the phase-1 kernels for Hopper (sm_90a): the forward
// (megakernel_fwd.cu), the replay backward and the fused L2 kernel
// (megakernel_bwd.cu) and the hand-adjoint kernel (megabwd_hand.cu).
//
// One body traces a pixel's path for all of them (sweep_forward), so every
// kernel picks the same winners, the same sphere roots and the same occlusion
// bits, and a backward kernel that evaluates the forward again gets the
// forward's numbers bit for bit.  That needs -fmad=false: every product and
// sum rounds on its own, in the order of the plain PyTorch version
// (megakernel.py:tile_color_reference).
//
// * The scene is read through L1 (__ldg on const __restrict__ pointers): all
//   threads of a warp read the same primitive at the same time, so each load
//   is one broadcast.
// * The winner's attributes are read by index (the TPU kernels fetched them
//   with a one-hot matmul).
// * Full FP32, no tensor cores.
//
// Records: occ[d] bit l is set when light l is blocked from the point the
// pixel shades at depth d.  A path with no shaded point at depth d (it missed,
// or ended earlier) has every light bit set when shadows are on: that is what
// the TPU kernel records for a miss, whose light distance overflows to inf so
// that every shadow test counts as blocked.

#pragma once

#include <cuda_runtime.h>

namespace tpurt {

constexpr float T_MIN = 1e-4f;
constexpr float T_MAX = 1e30f;
constexpr float T_NONE = 1e30f;
constexpr float RAY_OFFSET_EPS = 1e-3f;
constexpr float MT_DET_EPS = 1e-9f;
constexpr float NORMALIZE_EPS = 1e-20f;
constexpr float BG0 = 0.05f, BG1 = 0.07f, BG2 = 0.10f;

// attribute columns (tpurt_torch/kernels/pack.py)
constexpr int ACOLS = 35;
constexpr int A_N0 = 3, A_N1 = 6, A_N2 = 9;
constexpr int A_KA = 18, A_KD = 21, A_KS = 24;
constexpr int A_SHIN = 27, A_REFL = 28, A_CENTER = 30;
constexpr int NGLOB_BASE = 15;

constexpr int THREADS = 256;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 a) { return scale(a, rsqrtf(dot(a, a) + NORMALIZE_EPS)); }
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return sub(d, scale(n, 2.0f * dot(d, n))); }
__device__ __forceinline__ V3 ld3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}
__device__ __forceinline__ V3 xyz(float4 a) { return {a.x, a.y, a.z}; }
// value of form (a | a.w) at point o: a.xyz . o + a.w
__device__ __forceinline__ float form_o(float4 a, V3 o) {
  return a.x * o.x + a.y * o.y + a.z * o.z + a.w;
}
// value of form a at direction d: a.xyz . d
__device__ __forceinline__ float form_d(float4 a, V3 d) {
  return a.x * d.x + a.y * d.y + a.z * d.z;
}

struct Scene {
  const float4* __restrict__ tri;   // (T, 3) float4: [N|-N.v0] [r1|c1] [r2|c2]
  const float4* __restrict__ sph;   // (S, 2) float4: [-2c|c.c-r^2] [c|0]
  const float* __restrict__ attrs;  // (T + S, ACOLS)
  const float* __restrict__ glob;   // (NGLOB_BASE + 6 L)
  int n_tris, n_sph, n_lights;
};

// the image and the slab of it that a launch covers
struct Frame {
  int height, width;
  float aspect;
  int max_depth, shadows, off, n_pix;
};

// t of triangle i in (T_MIN, T_MAX), else T_NONE; u, v at that t
__device__ __forceinline__ float tri_t(const Scene& s, int i, V3 o, V3 d, float& u, float& v) {
  const float4 fn = __ldg(s.tri + 3 * i);
  const float4 fu = __ldg(s.tri + 3 * i + 1);
  const float4 fv = __ldg(s.tri + 3 * i + 2);
  const float no = form_o(fn, o);
  const float ndd = form_d(fn, d);
  const bool good = fabsf(ndd) >= MT_DET_EPS;
  const float t = -no / (good ? ndd : 1.0f);
  u = form_o(fu, o) + t * form_d(fu, d);
  v = form_o(fv, o) + t * form_d(fv, d);
  const bool hit = good && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > T_MIN && t < T_MAX;
  return hit ? t : T_NONE;
}

// nearest root of sphere j in (T_MIN, T_MAX), else T_NONE; first says that the
// root is -b - sqrt(disc), the selector the backward uses in place of a float
// comparison
__device__ __forceinline__ float sph_t(const Scene& s, int j, V3 o, V3 d, float oo, float od,
                                       bool& first) {
  const float4 fc = __ldg(s.sph + 2 * j);
  const float4 fd = __ldg(s.sph + 2 * j + 1);
  const float b = od - form_d(fd, d);
  const float cterm = oo + form_o(fc, o);
  const float disc = b * b - cterm;
  const bool has = disc > 0.0f;
  const float sq = sqrtf(has ? disc : 1.0f);
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  first = has && t0 > T_MIN && t0 < T_MAX;
  if (first) return t0;
  if (has && t1 > T_MIN && t1 < T_MAX) return t1;
  return T_NONE;
}

struct Hit {
  float t, u, v;
  int idx;     // row of attrs: triangle i, or n_tris + sphere j; -1 for a miss
  bool first;  // a sphere's nearer root won
};

// triangles before spheres, strict <: the lowest index wins a tie
__device__ inline Hit closest(const Scene& s, V3 o, V3 d) {
  Hit h{T_NONE, 0.0f, 0.0f, -1, false};
  for (int i = 0; i < s.n_tris; ++i) {
    float u, v;
    const float t = tri_t(s, i, o, d, u, v);
    if (t < h.t) h = {t, u, v, i, false};
  }
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < s.n_sph; ++j) {
    bool first;
    const float t = sph_t(s, j, o, d, oo, od, first);
    if (t < h.t) h = {t, 0.0f, 0.0f, s.n_tris + j, first};
  }
  return h;
}

// any primitive at t < tmax along the ray
__device__ inline bool occluded(const Scene& s, V3 o, V3 d, float tmax) {
  for (int i = 0; i < s.n_tris; ++i) {
    float u, v;
    if (tri_t(s, i, o, d, u, v) < tmax) return true;
  }
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < s.n_sph; ++j) {
    bool first;
    if (sph_t(s, j, o, d, oo, od, first) < tmax) return true;
  }
  return false;
}

// camera ray of flat pixel pix: o = eye, d = normalize(graw),
// graw = fwd + right * sx + up * sy
struct CameraRay {
  V3 o, d, graw;
  float sx, sy;
};

__device__ __forceinline__ CameraRay raygen(const Scene& s, const Frame& f, int pix) {
  const float row = static_cast<float>(pix / f.width);
  const float col = static_cast<float>(pix % f.width);
  CameraRay r;
  r.sx = (2.0f * (col + 0.5f) / static_cast<float>(f.width) - 1.0f) * f.aspect;
  r.sy = 1.0f - 2.0f * (row + 0.5f) / static_cast<float>(f.height);
  const float* g = s.glob;
  const V3 fwd = ld3(g + 3), right_h = ld3(g + 6), up_h = ld3(g + 9);
  r.o = ld3(g);
  r.graw = add(fwd, add(scale(right_h, r.sx), scale(up_h, r.sy)));
  r.d = normalize(r.graw);
  return r;
}

// shading normal at hit h of ray (o, d): interpolated and two-sided on a
// triangle, radial and not flipped on a sphere
__device__ __forceinline__ V3 surface_normal(const Scene& s, const float* a, const Hit& h, V3 p,
                                             V3 d) {
  if (h.idx < s.n_tris) {
    const float w = 1.0f - h.u - h.v;
    const V3 ni = normalize(
        add(scale(ld3(a + A_N0), w), add(scale(ld3(a + A_N1), h.u), scale(ld3(a + A_N2), h.v))));
    return dot(ni, d) > 0.0f ? neg(ni) : ni;
  }
  return normalize(sub(p, ld3(a + A_CENTER)));
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
// clip) and returns the number of depths visited, a final miss included.
//   kRecorded: visibility comes from occ[k * stride] and no shadow ray is
//     traced; otherwise shadow rays are traced and occ[k * stride] is written
//     for every depth up to max_depth.
//   kKeep: res[k * THREADS] is filled for every visited depth (a thread's
//     residuals in a block's shared memory, [depth][thread]).
template <bool kRecorded, bool kKeep>
__device__ __forceinline__ int sweep_forward(const Scene& s, V3 o, V3 d, int max_depth,
                                             int shadows, int* occ, long long stride,
                                             Residual* res, float& acc0, float& acc1,
                                             float& acc2) {
  const float* g = s.glob;
  const V3 ambient = ld3(g + 12);
  const int full = shadows ? static_cast<int>((1u << s.n_lights) - 1u) : 0;
  float thr = 1.0f;
  int depth = 0;
  int visited = 0;
  for (; depth <= max_depth; ++depth) {
    const Hit h = closest(s, o, d);
    visited = depth + 1;
    if (kKeep) res[depth * THREADS] = {o, d, thr, h.t, h.u, h.v, 2 * h.idx + (h.first ? 1 : 0)};
    if (!(h.t < T_MAX)) {  // miss: background, and the path ends
      acc0 = acc0 + thr * BG0;
      acc1 = acc1 + thr * BG1;
      acc2 = acc2 + thr * BG2;
      break;
    }
    const V3 p = add(o, scale(d, h.t));
    const float* a = s.attrs + static_cast<long long>(h.idx) * ACOLS;
    const V3 n = surface_normal(s, a, h, p, d);
    const V3 ka = ld3(a + A_KA), kd = ld3(a + A_KD), ks = ld3(a + A_KS);
    const float shin = __ldg(a + A_SHIN);
    const float refl = __ldg(a + A_REFL);

    float c0 = ka.x * ambient.x, c1 = ka.y * ambient.y, c2 = ka.z * ambient.z;
    const V3 view = neg(d);
    const V3 p_off = add(p, scale(n, RAY_OFFSET_EPS));
    const int rec = kRecorded ? occ[depth * stride] : 0;
    int bits = 0;
    for (int li = 0; li < s.n_lights; ++li) {
      const V3 lpos = ld3(g + NGLOB_BASE + 3 * li);
      const V3 lcol = ld3(g + NGLOB_BASE + 3 * s.n_lights + 3 * li);
      const V3 to_l = sub(lpos, p);
      const float dist = sqrtf(dot(to_l, to_l));
      const V3 ldir = scale(to_l, 1.0f / fmaxf(dist, 1e-20f));
      const float ndotl = fmaxf(dot(n, ldir), 0.0f);
      const V3 refl_l = reflect(neg(ldir), n);
      const float rdotv = fmaxf(dot(refl_l, view), 0.0f);
      const float safe_rv = rdotv > 0.0f ? rdotv : 1.0f;
      const float spec = (ndotl > 0.0f && rdotv > 0.0f) ? powf(safe_rv, shin) : 0.0f;
      float vis = 1.0f;
      if (kRecorded) {
        if (shadows && ((rec >> li) & 1)) vis = 0.0f;
      } else if (shadows && occluded(s, p_off, ldir, dist - RAY_OFFSET_EPS)) {
        bits |= 1 << li;
        vis = 0.0f;
      }
      c0 = c0 + vis * lcol.x * (kd.x * ndotl + ks.x * spec);
      c1 = c1 + vis * lcol.y * (kd.y * ndotl + ks.y * spec);
      c2 = c2 + vis * lcol.z * (kd.z * ndotl + ks.z * spec);
    }
    if (!kRecorded) occ[depth * stride] = bits;
    acc0 = acc0 + thr * c0;
    acc1 = acc1 + thr * c1;
    acc2 = acc2 + thr * c2;
    thr = thr * refl;
    if (!(refl > 0.0f)) {
      ++depth;
      break;
    }
    o = p_off;
    d = reflect(d, n);
  }
  if (!kRecorded) {
    // the miss's own depth and every later one: no shaded point
    for (int k = depth; k <= max_depth; ++k) occ[k * stride] = full;
  }
  return visited;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

}  // namespace tpurt

extern "C" {
// out[j] = sum over r of partials[r * n + j], r in order; defined in
// megakernel_bwd.cu.  Returns cudaGetLastError().
int tpurt_reduce_rows(const void* partials, void* out, int rows, int n, void* stream);
}
