// Device code shared by the phase-1 kernels for Hopper (sm_90a) and the
// traversal kernels (traversal.cu): constants, vector helpers, the packed
// scene, and the unfused triangle, sphere and camera-ray arithmetic that the
// traversal kernels use.  The phase-1 kernels' own body, with its written-out
// FMA and early rejections, is phase1_math.cuh.
//
// Built with -fmad=false: every product and sum here rounds on its own, in
// the order of the plain PyTorch versions (megakernel.py:_tri_t, _sph_t,
// _raygen, which traversal.py uses).
//
// * The scene is read through L1 (__ldg on const __restrict__ pointers): all
//   threads of a warp read the same primitive at the same time, so each load
//   is one broadcast.
// * Full FP32, no tensor cores.

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

}  // namespace tpurt

extern "C" {
// out[j] = sum over r of partials[r * n + j], r in order; defined in
// megakernel_bwd.cu.  Returns cudaGetLastError().
int tpurt_reduce_rows(const void* partials, void* out, int rows, int n, void* stream);
}
