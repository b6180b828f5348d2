// Phase-1 forward megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpurt/kernels/megakernel.py:_fwd_kernel (body
// _tile_color): per pixel, ray-gen -> closest hit over every triangle
// (Baldwin-Weber forms) and sphere (form-based quadratic), lowest index wins
// -> Phong with one binary shadow any-hit per light -> Whitted loop to
// max_depth weighted by reflectivity -> clip to [0, 1].
//
// What bounds it on an H100: FP32 ALU work and warp divergence, not bytes.
// For config 3 at 1080x1920 the outputs are 2.07 M px x (12 + 12) B, about
// 50 MB a frame, and the packed scene is a few hundred bytes; each pixel
// runs up to 3 closest-hit and 6 shadow passes over 5 primitives.
//
// Design:
// * One thread per pixel on a 1-D grid over n_pix, masked at the ragged
//   end; the TPU kernel's tile padding is gone.
// * Dead rays exit per thread (in place of the TPU's tile-level lax.cond
//   skips), and a shadow test returns at the first occluder.
// * The scene is read through L1 (__ldg on const __restrict__ pointers): all
//   threads of a warp read the same primitive at the same time, so each load
//   is one broadcast.  Staging primitives in shared memory is a lever for a
//   later change; at the phase-1 limit (4096 tris x 48 B + 4096 spheres x
//   32 B) the tables exceed the 227 KB a block can use, so it needs chunks.
// * The winner's attributes are read by index (the TPU fetched them with a
//   one-hot matmul).
// * Full FP32, no tensor cores.  Built with -fmad=false so that every
//   product and sum rounds on its own, in the order of the plain PyTorch
//   version (megakernel.py:tile_color_reference); contracting to FMA is a
//   lever for a later change.
//
// Records: occ[d, i] bit l is set when light l is blocked from the point
// pixel i shades at depth d.  A path with no shaded point at depth d (it
// missed, or ended earlier) has every light bit set when shadows are on:
// that is what the TPU kernel records for a miss, whose light distance
// overflows to inf so that every shadow test counts as blocked.

#include <cuda_runtime.h>

namespace {

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

// nearest root of sphere j in (T_MIN, T_MAX), else T_NONE
__device__ __forceinline__ float sph_t(const Scene& s, int j, V3 o, V3 d, float oo, float od) {
  const float4 fc = __ldg(s.sph + 2 * j);
  const float4 fd = __ldg(s.sph + 2 * j + 1);
  const float b = od - form_d(fd, d);
  const float cterm = oo + form_o(fc, o);
  const float disc = b * b - cterm;
  const bool has = disc > 0.0f;
  const float sq = sqrtf(has ? disc : 1.0f);
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  if (has && t0 > T_MIN && t0 < T_MAX) return t0;
  if (has && t1 > T_MIN && t1 < T_MAX) return t1;
  return T_NONE;
}

struct Hit {
  float t, u, v;
  int idx;  // row of attrs: triangle i, or n_tris + sphere j
};

// triangles before spheres, strict <: the lowest index wins a tie
__device__ Hit closest(const Scene& s, V3 o, V3 d) {
  Hit h{T_NONE, 0.0f, 0.0f, -1};
  for (int i = 0; i < s.n_tris; ++i) {
    float u, v;
    const float t = tri_t(s, i, o, d, u, v);
    if (t < h.t) h = {t, u, v, i};
  }
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < s.n_sph; ++j) {
    const float t = sph_t(s, j, o, d, oo, od);
    if (t < h.t) h = {t, 0.0f, 0.0f, s.n_tris + j};
  }
  return h;
}

// any primitive at t < tmax along the ray
__device__ bool occluded(const Scene& s, V3 o, V3 d, float tmax) {
  for (int i = 0; i < s.n_tris; ++i) {
    float u, v;
    if (tri_t(s, i, o, d, u, v) < tmax) return true;
  }
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < s.n_sph; ++j) {
    if (sph_t(s, j, o, d, oo, od) < tmax) return true;
  }
  return false;
}

__global__ void __launch_bounds__(256) megakernel_fwd(
    Scene s, float* __restrict__ colour, int* __restrict__ occ, int height, int width,
    float aspect, int max_depth, int shadows, int off, int n_pix) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const int pix = off + i;
  const float row = static_cast<float>(pix / width);
  const float col = static_cast<float>(pix % width);
  const float sx = (2.0f * (col + 0.5f) / static_cast<float>(width) - 1.0f) * aspect;
  const float sy = 1.0f - 2.0f * (row + 0.5f) / static_cast<float>(height);

  const float* g = s.glob;
  const V3 fwd = ld3(g + 3), right_h = ld3(g + 6), up_h = ld3(g + 9);
  const V3 ambient = ld3(g + 12);
  V3 o = ld3(g);
  V3 d = normalize(add(fwd, add(scale(right_h, sx), scale(up_h, sy))));

  const int full = shadows ? static_cast<int>((1u << s.n_lights) - 1u) : 0;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  float thr = 1.0f;
  int depth = 0;
  for (; depth <= max_depth; ++depth) {
    const Hit h = closest(s, o, d);
    if (!(h.t < T_MAX)) {  // miss: background, and the path ends
      acc0 = acc0 + thr * BG0;
      acc1 = acc1 + thr * BG1;
      acc2 = acc2 + thr * BG2;
      break;
    }
    const V3 p = add(o, scale(d, h.t));
    const float* a = s.attrs + static_cast<long long>(h.idx) * ACOLS;
    V3 n;
    if (h.idx < s.n_tris) {
      const float w = 1.0f - h.u - h.v;
      const V3 ni = normalize(
          add(scale(ld3(a + A_N0), w), add(scale(ld3(a + A_N1), h.u), scale(ld3(a + A_N2), h.v))));
      n = dot(ni, d) > 0.0f ? neg(ni) : ni;  // two-sided
    } else {
      n = normalize(sub(p, ld3(a + A_CENTER)));  // not flipped
    }
    const V3 ka = ld3(a + A_KA), kd = ld3(a + A_KD), ks = ld3(a + A_KS);
    const float shin = __ldg(a + A_SHIN);
    const float refl = __ldg(a + A_REFL);

    float c0 = ka.x * ambient.x, c1 = ka.y * ambient.y, c2 = ka.z * ambient.z;
    const V3 view = neg(d);
    const V3 p_off = add(p, scale(n, RAY_OFFSET_EPS));
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
      if (shadows && occluded(s, p_off, ldir, dist - RAY_OFFSET_EPS)) {
        bits |= 1 << li;
        vis = 0.0f;
      }
      c0 = c0 + vis * lcol.x * (kd.x * ndotl + ks.x * spec);
      c1 = c1 + vis * lcol.y * (kd.y * ndotl + ks.y * spec);
      c2 = c2 + vis * lcol.z * (kd.z * ndotl + ks.z * spec);
    }
    occ[static_cast<long long>(depth) * n_pix + i] = bits;
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
  // the miss's own depth and every later one: no shaded point
  for (int k = depth; k <= max_depth; ++k) occ[static_cast<long long>(k) * n_pix + i] = full;
  colour[i] = fminf(fmaxf(acc0, 0.0f), 1.0f);
  colour[n_pix + i] = fminf(fmaxf(acc1, 0.0f), 1.0f);
  colour[2LL * n_pix + i] = fminf(fmaxf(acc2, 0.0f), 1.0f);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  Outputs colour (3, n_pix) f32 and occ (max_depth + 1, n_pix)
// i32 are allocated by the caller.
int tpurt_megakernel_fwd(const void* tri_forms, const void* sph_forms, const void* attrs,
                         const void* glob, void* colour, void* occ, int n_tris, int n_sph,
                         int n_lights, int height, int width, float aspect, int max_depth,
                         int shadows, int off, int n_pix, void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
          static_cast<const float*>(attrs), static_cast<const float*>(glob), n_tris, n_sph,
          n_lights};
  constexpr int threads = 256;
  const int blocks = (n_pix + threads - 1) / threads;
  megakernel_fwd<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<float*>(colour), static_cast<int*>(occ), height, width, aspect, max_depth,
      shadows, off, n_pix);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
