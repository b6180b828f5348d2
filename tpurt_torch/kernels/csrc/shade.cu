// K11 shade_records_kernel: deferred shading of the clusters plan on Hopper
// (sm_90a), the Whitted replay of shading/deferred.py:_shade_bundle in one
// launch, for calls that want no gradient.
//
// Replaces no TPU kernel: tpurt/shading/deferred.py is JAX that XLA fuses.
// Its PyTorch counterpart runs about 60 tensor ops a depth over (N, 3)
// tensors, each a launch and a round trip of its operands through device
// memory; this kernel is the same arithmetic with the intermediates kept in
// registers.
//
// What bounds it on an H100: bytes.  Per pixel it reads the records (9 B a
// depth), o and d (24 B) and writes the colour (12 B); per hit it reads one
// triangle's or sphere's rows, a material row and, on a textured material,
// four texels.  A few hundred FP32 operations a pixel are far below the
// card's rate.
//
// Design:
// * One thread a pixel, in pixel order, so the loads of the records, o and d
//   and the store of the colour are coalesced.  The loop over depths runs
//   inside the thread: throughput, the accumulated colour, origin and
//   direction stay in registers, and a lane whose path ends stops at once
//   (the PyTorch route syncs with the host once a depth to skip a depth with
//   no live lane).
// * The scene's leaves are read where they are (vertices, vnormals, uvs,
//   triangles, materials, spheres, the flat texture table, lights): none of
//   the merged tables of the PyTorch route is built.
// * The arithmetic is the PyTorch route's, op for op and in its order, with
//   the functions that PyTorch's CUDA kernels call (rsqrtf for torch.rsqrt,
//   sqrtf, powf, floorf, IEEE division); with -fmad=false every product and
//   sum rounds on its own, as there.  A sum over a trailing axis of 3
//   (vec.dot) is added as PyTorch's reduction adds it (sum3).
// * Every constant of tpurt_torch/constants.py that the shading reads comes
//   in as an argument (ShadeConsts), none as a literal.

#include <cuda_runtime.h>

namespace {

constexpr int SHADE_THREADS = 256;

struct ShadeScene {
  const int* prim;            // (depths, n) records: triangle or sphere index, -1 a miss
  const unsigned char* tri;   // (depths, n) bool: the hit is a triangle
  const int* occ;             // (depths, n) bit l: light l is occluded
  const float* o;             // (n, 3), rows o_stride floats apart (0: one origin)
  const float* d;             // (n, 3), rows d_stride floats apart
  const float* vertices;      // (V, 3)
  const float* vnormals;      // (V, 3)
  const float* uvs;           // (V, 2)
  const int* triangles;       // (T, 3)
  const int* tri_mat;         // (T,)
  const float* sph_center;    // (S, 3)
  const float* sph_radius;    // (S,)
  const int* sph_mat;         // (S,)
  const float* ka;            // (M, 3)
  const float* kd;            // (M, 3)
  const float* ks;            // (M, 3)
  const float* shininess;     // (M,)
  const float* reflectivity;  // (M,)
  const int* texture_id;      // (M,) -1: untextured
  const float* textures;      // (NT, th, tw, 3)
  const float* light_pos;     // (L, 3)
  const float* light_color;   // (L, 3)
  const float* ambient;       // (3,)
  int o_stride, d_stride, n, n_tris, n_spheres, has_spheres, th, tw, n_lights;
  int max_depth, shadows, smooth, textured;
};

struct ShadeConsts {
  float background[3];
  float clamp_lo, clamp_hi;
  float ray_offset_eps, mt_det_eps, t_min, t_max, normalize_eps, light_dist_min;
};

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, F3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ F3 operator*(float s, F3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ F3 operator-(F3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ F3 row3(const float* __restrict__ p, long long r, int stride = 3) {
  p += stride * r;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// torch.sum over a trailing axis of 3 on the card: the reduction splits the
// axis over two lanes (elements 0 and 2 on the first, 1 on the second) and
// joins them with one shuffle
__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + c) + b; }

__device__ __forceinline__ float dot(F3 a, F3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }

__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// vec.normalize: a * rsqrt(a.a + eps)
__device__ __forceinline__ F3 normalize(F3 a, float eps) { return rsqrtf(dot(a, a) + eps) * a; }

// vec.reflect: d - (2 (d.n)) n
__device__ __forceinline__ F3 reflect(F3 d, F3 n) { return d - (2.0f * dot(d, n)) * n; }

// clamp_min as PyTorch's CUDA kernel: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.remainder of int64 by a positive divisor
__device__ __forceinline__ long long wrap(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// ref/oracle.py:bilinear_texels at one texture id and uv: the four texels of
// the wrap lookup, weighted left to right as there
__device__ F3 bilinear(const ShadeScene& s, int tid, float uu, float vv) {
  const float u = uu - floorf(uu), v = vv - floorf(vv);
  const float x = u * static_cast<float>(s.tw) - 0.5f;
  const float y = v * static_cast<float>(s.th) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long xa = wrap(static_cast<long long>(x0), s.tw);
  const long long xb = wrap(static_cast<long long>(x0 + 1.0f), s.tw);
  const long long ya = wrap(static_cast<long long>(y0), s.th);
  const long long yb = wrap(static_cast<long long>(y0 + 1.0f), s.th);
  const long long base = static_cast<long long>(tid) * s.th;
  const F3 c00 = row3(s.textures, (base + ya) * s.tw + xa);
  const F3 c10 = row3(s.textures, (base + ya) * s.tw + xb);
  const F3 c01 = row3(s.textures, (base + yb) * s.tw + xa);
  const F3 c11 = row3(s.textures, (base + yb) * s.tw + xb);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return ((gy * (gx * c00) + gy * (fx * c10)) + fy * (gx * c01)) + fy * (fx * c11);
}

__global__ void __launch_bounds__(SHADE_THREADS)
    shade_records_kernel(const ShadeScene s, const ShadeConsts k, float* __restrict__ out) {
  const int i = blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= s.n) return;
  F3 o = row3(s.o, i, s.o_stride), d = row3(s.d, i, s.d_stride);
  F3 acc{0.0f, 0.0f, 0.0f};
  float thr = 1.0f;
  const F3 bg{k.background[0], k.background[1], k.background[2]};
  for (int depth = 0; depth <= s.max_depth; ++depth) {
    const long long at = static_cast<long long>(depth) * s.n + i;
    const int prim = __ldg(s.prim + at);
    if (prim < 0) {  // a miss: the background, and the path ends
      acc = acc + thr * bg;
      break;
    }
    const bool is_tri = __ldg(s.tri + at) != 0;
    const int occ = __ldg(s.occ + at);

    // _recompute_tuv and _hit_geometry at the recorded primitive; a sphere
    // hit on a scene without spheres takes the triangle route's rows, with t,
    // u and v zero, as there
    const bool tri_rows = is_tri || !s.has_spheres;
    float t = 0.0f, u = 0.0f, v = 0.0f;
    F3 n{0.0f, 0.0f, 0.0f};
    int mat = 0;
    F3 uv_w{0.0f, 0.0f, 0.0f};  // corner weights of the uv: w, u, v
    int c0 = 0, c1 = 0, c2 = 0;
    if (tri_rows) {
      const int pid = min(prim, s.n_tris - 1);
      c0 = __ldg(s.triangles + 3 * pid);
      c1 = __ldg(s.triangles + 3 * pid + 1);
      c2 = __ldg(s.triangles + 3 * pid + 2);
      const F3 v0 = row3(s.vertices, c0);
      const F3 e1 = row3(s.vertices, c1) - v0, e2 = row3(s.vertices, c2) - v0;
      if (is_tri) {
        const F3 pvec = cross(d, e2);
        const float det = dot(e1, pvec);
        const float inv_det = 1.0f / (fabsf(det) < k.mt_det_eps ? 1.0f : det);
        const F3 tvec = o - v0;
        u = dot(tvec, pvec) * inv_det;
        const F3 qvec = cross(tvec, e1);
        v = dot(d, qvec) * inv_det;
        t = dot(e2, qvec) * inv_det;
      }
      const float w = (1.0f - u) - v;
      uv_w = {w, u, v};
      F3 nt;
      if (s.smooth) {
        nt = normalize((w * row3(s.vnormals, c0) + u * row3(s.vnormals, c1)) +
                           v * row3(s.vnormals, c2),
                       k.normalize_eps);
      } else {
        nt = normalize(cross(e1, e2), k.normalize_eps);
      }
      n = dot(nt, d) > 0.0f ? -nt : nt;
      mat = __ldg(s.tri_mat + pid);
    }
    F3 p;
    if (tri_rows) {
      p = o + t * d;
    } else {
      const int sid = min(prim, s.n_spheres - 1);
      const F3 c = row3(s.sph_center, sid);
      const float rad = __ldg(s.sph_radius + sid);
      const F3 oc = o - c;
      const float b = dot(oc, d);
      const float disc = b * b - (dot(oc, oc) - rad * rad);
      const bool has = disc > 0.0f;
      const float sq = sqrtf(has ? disc : 1.0f);
      const float t0 = -b - sq;
      t = (has && t0 > k.t_min && t0 < k.t_max) ? t0 : -b + sq;
      p = o + t * d;
      n = normalize(p - c, k.normalize_eps);
      mat = __ldg(s.sph_mat + sid);
    }

    // the material row, the texture, Phong for every light
    const F3 ka = row3(s.ka, mat), ks = row3(s.ks, mat);
    F3 kd = row3(s.kd, mat);
    const float shin = __ldg(s.shininess + mat);
    if (s.textured) {
      const int tex = __ldg(s.texture_id + mat);
      if (tex >= 0) {
        float tu = 0.0f, tv = 0.0f;
        if (is_tri) {
          const float* uv = s.uvs;
          tu = (uv_w.x * __ldg(uv + 2 * c0) + uv_w.y * __ldg(uv + 2 * c1)) +
               uv_w.z * __ldg(uv + 2 * c2);
          tv = (uv_w.x * __ldg(uv + 2 * c0 + 1) + uv_w.y * __ldg(uv + 2 * c1 + 1)) +
               uv_w.z * __ldg(uv + 2 * c2 + 1);
        }
        kd = kd * bilinear(s, tex, tu, tv);
      }
    }
    const F3 amb{__ldg(s.ambient), __ldg(s.ambient + 1), __ldg(s.ambient + 2)};
    F3 colour = ka * amb;
    const F3 view = -d;
    for (int li = 0; li < s.n_lights; ++li) {
      const F3 to_l = row3(s.light_pos, li) - p;
      const float dist = sqrtf(dot(to_l, to_l));
      const float dl = clamp_min(dist, k.light_dist_min);
      const F3 ldir{to_l.x / dl, to_l.y / dl, to_l.z / dl};
      const float ndotl = clamp_min(dot(n, ldir), 0.0f);
      const float rdotv = clamp_min(dot(reflect(-ldir, n), view), 0.0f);
      const float spec = (ndotl > 0.0f && rdotv > 0.0f) ? powf(rdotv, shin) : 0.0f;
      const float vis = (s.shadows && ((occ >> li) & 1)) ? 0.0f : 1.0f;
      colour = colour + (vis * row3(s.light_color, li)) * (ndotl * kd + spec * ks);
    }
    acc = acc + thr * colour;
    const float refl = __ldg(s.reflectivity + mat);
    thr = thr * refl;
    if (!(refl > 0.0f)) break;
    o = p + k.ray_offset_eps * n;
    d = reflect(d, n);
  }
  out[3LL * i] = clamp(acc.x, k.clamp_lo, k.clamp_hi);
  out[3LL * i + 1] = clamp(acc.y, k.clamp_lo, k.clamp_hi);
  out[3LL * i + 2] = clamp(acc.z, k.clamp_lo, k.clamp_hi);
}

}  // namespace

extern "C" {

// K11: colours (n, 3) f32 of n pixels from their records (depths >=
// max_depth + 1 rows of n), rays and the scene's leaves, all contiguous on
// one card (kernels/shade.py checks them).  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
int tpurt_shade_records(const void* prim, const void* is_tri, const void* occ, int n,
                        const void* o, int o_stride, const void* d, int d_stride,
                        const void* vertices, const void* vnormals,
                        const void* uvs, const void* triangles, const void* tri_mat, int n_tris,
                        const void* sph_center, const void* sph_radius, const void* sph_mat,
                        int n_spheres, int has_spheres, const void* ka, const void* kd,
                        const void* ks, const void* shininess, const void* reflectivity,
                        const void* texture_id, const void* textures, int th, int tw,
                        const void* light_pos, const void* light_color, const void* ambient,
                        int n_lights, int max_depth, int shadows, int smooth, int textured,
                        float bg_r, float bg_g, float bg_b, float clamp_lo, float clamp_hi,
                        float ray_offset_eps, float mt_det_eps, float t_min, float t_max,
                        float normalize_eps, float light_dist_min, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_tris < 1 || n_spheres < 1 || n_lights < 0 || max_depth < 0 || th < 1 || tw < 1 ||
      o_stride < 0 || d_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ShadeScene s{
      static_cast<const int*>(prim), static_cast<const unsigned char*>(is_tri),
      static_cast<const int*>(occ), static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(vertices), static_cast<const float*>(vnormals),
      static_cast<const float*>(uvs), static_cast<const int*>(triangles),
      static_cast<const int*>(tri_mat), static_cast<const float*>(sph_center),
      static_cast<const float*>(sph_radius), static_cast<const int*>(sph_mat),
      static_cast<const float*>(ka), static_cast<const float*>(kd), static_cast<const float*>(ks),
      static_cast<const float*>(shininess), static_cast<const float*>(reflectivity),
      static_cast<const int*>(texture_id), static_cast<const float*>(textures),
      static_cast<const float*>(light_pos), static_cast<const float*>(light_color),
      static_cast<const float*>(ambient), o_stride, d_stride, n, n_tris, n_spheres, has_spheres,
      th, tw, n_lights,
      max_depth, shadows, smooth, textured};
  const ShadeConsts k{{bg_r, bg_g, bg_b}, clamp_lo,   clamp_hi, ray_offset_eps,
                      mt_det_eps,         t_min,      t_max,    normalize_eps,
                      light_dist_min};
  shade_records_kernel<<<(n + SHADE_THREADS - 1) / SHADE_THREADS, SHADE_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(s, k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
