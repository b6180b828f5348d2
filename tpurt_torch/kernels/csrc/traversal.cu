// Cluster traversal kernel for Hopper (sm_90a): the clustered render path's
// topology search.
//
// Replaces the three modes of the TPU kernel
// tpurt/kernels/traversal.py:_trav_kernel:
//   trace_records  (mode 0)  camera rays of a slab of pixels; per depth the
//                            closest hit, the shading normal and offset point,
//                            one any-hit per light, the reflection continuation
//   trace_bounce   (mode 1)  one depth of the same over an explicit ray set
//   trace_shadows  (mode 2)  any-hit to every light from given hit points
// It computes what that kernel computes and shares nothing of its structure:
// the TPU kernel culls all clusters against a 1024-ray tile, packs survivor
// lists, and streams surviving clusters through a DMA pipeline into dense
// matrix products, because it has no per-lane control flow.  Here every ray
// has a thread of its own:
// * an upper level, a binary tree over consecutive ranges of clusters (frozen
//   topology, boxes refit every frame by packc.py), is walked with a short
//   per-thread stack, nearer child first, and a subtree is skipped once its
//   entry distance exceeds the best hit so far;
// * inside a cluster the thread loops over the triangle slots with the
//   phase-1 kernels' Baldwin-Weber test (megakernel_common.cuh: tri_t, sph_t);
// * an any-hit ray returns at the first occluder.
//
// The records contract (traversal.py states it through the plain versions):
// least t in (T_MIN, T_MAX); at equal t the smaller global id wins; a lane is
// live at depth d only if every earlier depth hit a reflective material; dead
// and missing lanes get id -1, occ 0, t T_NONE; a shadow ray starts at
// p + eps n, points along (light - p) / dist and is tested in
// (T_MIN, dist - eps).  Boxes only ever skip work: they are widened by
// packc.BOX_MARGIN, so the records equal brute force over every slot.
//
// What bounds it on an H100: FP32 ALU work and divergence, not bytes.  A ray
// makes some hundreds of triangle tests of about 40 operations on 48 bytes
// that neighbouring threads mostly share through L1 and L2, and the records
// are 12 bytes a depth.  Full FP32 with -fmad=false, so that kernel and plain
// version agree to the bit; no tensor cores.  Levers for a later change:
// boxes over 8 or 16 slots inside a cluster, a wider upper level, staging a
// cluster in shared memory for the rays of a warp that enter it together.
//
// The counting instantiation (kCount) adds up, per launch: box tests of the
// upper level, clusters entered, triangle tests, sphere tests, rays traced.
// The timed instantiation carries none of it.

#include "megakernel_common.cuh"

namespace tpurt {

// attribute columns (tpurt_torch/kernels/packc.py)
constexpr int TROWS = 16;
constexpr int R_N0 = 0, R_N1 = 3, R_N2 = 6, R_GID = 9, R_CENTER = 10, R_REFL = 14;

constexpr int MAX_STACK = 64;  // traversal.py: MAX_STACK
constexpr int TRAV_THREADS = 128;

struct Clusters {
  Scene s;                            // tri: (C * leaf, 3) forms; sph; glob; attrs unused
  const float* __restrict__ tattr;    // (C * leaf, TROWS)
  const float4* __restrict__ boxes;   // (2C - 1, 2): inner nodes, then clusters
  const int2* __restrict__ children;  // (C - 1): references into boxes
  const float* __restrict__ sattr;    // (S, TROWS)
  int n_clusters, leaf, n_tris;
};

struct Counts {
  unsigned long long nodes, clusters, tris, sph, rays;
};

struct ClusterHit {
  float t, u, v;
  int gid;              // global id, -1 for a miss
  const float* attr;    // the winner's attribute row
};

__device__ __forceinline__ int gid_of(const float* attr) {
  return __float2int_rn(__ldg(attr + R_GID));
}

// distance at which the ray enters box `ref` within [0, tmax], else +inf
__device__ __forceinline__ float box_entry(const float4* __restrict__ boxes, int ref, V3 o, V3 inv,
                                           float tmax) {
  const float4 lo = __ldg(boxes + 2 * ref);
  const float4 hi = __ldg(boxes + 2 * ref + 1);
  const float x0 = (lo.x - o.x) * inv.x, x1 = (hi.x - o.x) * inv.x;
  const float y0 = (lo.y - o.y) * inv.y, y1 = (hi.y - o.y) * inv.y;
  const float z0 = (lo.z - o.z) * inv.z, z1 = (hi.z - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), 0.0f));
  const float tf = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fminf(fmaxf(z0, z1), tmax));
  return tn <= tf ? tn : __int_as_float(0x7f800000);
}

// nearest hit over the resident spheres and every cluster
template <bool kCount>
__device__ inline ClusterHit closest_hit(const Clusters& c, V3 o, V3 d, Counts& n) {
  ClusterHit h{T_NONE, 0.0f, 0.0f, -1, nullptr};
  if (kCount) n.rays += 1;
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < c.s.n_sph; ++j) {
    bool first;
    const float t = sph_t(c.s, j, o, d, oo, od, first);
    if (t < h.t) {
      const float* a = c.sattr + j * TROWS;
      h = {t, 0.0f, 0.0f, gid_of(a), a};
    }
  }
  if (kCount) n.sph += c.s.n_sph;

  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const int n_inner = c.n_clusters - 1;
  int refs[MAX_STACK];
  float entry[MAX_STACK];
  int sp = 0;
  {
    const float te = box_entry(c.boxes, 0, o, inv, h.t);
    if (kCount) n.nodes += 1;
    if (te <= h.t) {
      refs[0] = 0;
      entry[0] = te;
      sp = 1;
    }
  }
  while (sp > 0) {
    --sp;
    const int ref = refs[sp];
    if (entry[sp] > h.t) continue;  // a nearer hit was found since the push
    if (ref >= n_inner) {
      const int base = (ref - n_inner) * c.leaf;
      if (kCount) {
        n.clusters += 1;
        n.tris += c.leaf;
      }
      for (int s = 0; s < c.leaf; ++s) {
        float u, v;
        const float t = tri_t(c.s, base + s, o, d, u, v);
        if (t < h.t) {
          const float* a = c.tattr + static_cast<long long>(base + s) * TROWS;
          h = {t, u, v, gid_of(a), a};
        } else if (t == h.t && t < T_NONE) {
          const float* a = c.tattr + static_cast<long long>(base + s) * TROWS;
          const int g = gid_of(a);
          if (g < h.gid) h = {t, u, v, g, a};
        }
      }
    } else {
      const int2 ch = __ldg(c.children + ref);
      const float t0 = box_entry(c.boxes, ch.x, o, inv, h.t);
      const float t1 = box_entry(c.boxes, ch.y, o, inv, h.t);
      if (kCount) n.nodes += 2;
      // the farther child first, so that the nearer one is popped next
      const bool x_near = t0 <= t1;
      const int ref_far = x_near ? ch.y : ch.x;
      const float t_far = x_near ? t1 : t0;
      const int ref_near = x_near ? ch.x : ch.y;
      const float t_near = x_near ? t0 : t1;
      if (t_far <= h.t) {
        refs[sp] = ref_far;
        entry[sp] = t_far;
        ++sp;
      }
      if (t_near <= h.t) {
        refs[sp] = ref_near;
        entry[sp] = t_near;
        ++sp;
      }
    }
  }
  return h;
}

// any primitive at t in (T_MIN, tmax) along the ray
template <bool kCount>
__device__ inline bool any_hit(const Clusters& c, V3 o, V3 d, float tmax, Counts& n) {
  if (kCount) n.rays += 1;
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < c.s.n_sph; ++j) {
    bool first;
    if (kCount) n.sph += 1;
    if (sph_t(c.s, j, o, d, oo, od, first) < tmax) return true;
  }
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const int n_inner = c.n_clusters - 1;
  int refs[MAX_STACK];
  int sp = 0;
  if (kCount) n.nodes += 1;
  if (box_entry(c.boxes, 0, o, inv, tmax) <= tmax) {
    refs[0] = 0;
    sp = 1;
  }
  while (sp > 0) {
    const int ref = refs[--sp];
    if (ref >= n_inner) {
      const int base = (ref - n_inner) * c.leaf;
      if (kCount) n.clusters += 1;
      for (int s = 0; s < c.leaf; ++s) {
        float u, v;
        if (kCount) n.tris += 1;
        if (tri_t(c.s, base + s, o, d, u, v) < tmax) return true;
      }
    } else {
      const int2 ch = __ldg(c.children + ref);
      const float t0 = box_entry(c.boxes, ch.x, o, inv, tmax);
      const float t1 = box_entry(c.boxes, ch.y, o, inv, tmax);
      if (kCount) n.nodes += 2;
      const bool x_near = t0 <= t1;
      if ((x_near ? t1 : t0) <= tmax) refs[sp++] = x_near ? ch.y : ch.x;
      if ((x_near ? t0 : t1) <= tmax) refs[sp++] = x_near ? ch.x : ch.y;
    }
  }
  return false;
}

// bit l: light l is blocked from p, the ray starting at p_off
template <bool kCount>
__device__ inline int shadow_bits(const Clusters& c, V3 p, V3 p_off, Counts& n) {
  const float* g = c.s.glob;
  int bits = 0;
  for (int li = 0; li < c.s.n_lights; ++li) {
    const V3 to_l = sub(ld3(g + NGLOB_BASE + 3 * li), p);
    const float dist = sqrtf(dot(to_l, to_l));
    const V3 ldir = scale(to_l, 1.0f / fmaxf(dist, 1e-20f));
    if (any_hit<kCount>(c, p_off, ldir, dist - RAY_OFFSET_EPS, n)) bits |= 1 << li;
  }
  return bits;
}

// records of one path for depths 0..max_depth, written at ids[k * stride] etc.
template <bool kCount>
__device__ inline void whitted_records(const Clusters& c, V3 o, V3 d, bool alive, int max_depth,
                                       int shadows, int* ids, int* occ, float* tb,
                                       long long stride, Counts& n) {
  for (int depth = 0; depth <= max_depth; ++depth) {
    int id = -1, bits = 0;
    float tbest = T_NONE;
    if (alive) {
      const ClusterHit h = closest_hit<kCount>(c, o, d, n);
      alive = false;
      if (h.t < T_MAX) {
        const float* a = h.attr;
        const V3 p = add(o, scale(d, h.t));
        V3 nrm;
        if (h.gid < c.n_tris) {
          const float w = 1.0f - h.u - h.v;
          const V3 ni = normalize(add(scale(ld3(a + R_N0), w),
                                      add(scale(ld3(a + R_N1), h.u), scale(ld3(a + R_N2), h.v))));
          nrm = dot(ni, d) > 0.0f ? neg(ni) : ni;
        } else {
          nrm = normalize(sub(p, ld3(a + R_CENTER)));
        }
        const V3 p_off = add(p, scale(nrm, RAY_OFFSET_EPS));
        if (shadows) bits = shadow_bits<kCount>(c, p, p_off, n);
        id = h.gid;
        tbest = h.t;
        alive = __ldg(a + R_REFL) > 0.0f;
        o = p_off;
        d = reflect(d, nrm);
      }
    }
    ids[depth * stride] = id;
    occ[depth * stride] = bits;
    tb[depth * stride] = tbest;
  }
}

__device__ __forceinline__ void flush(unsigned long long* stats, const Counts& n) {
  atomicAdd(stats + 0, n.nodes);
  atomicAdd(stats + 1, n.clusters);
  atomicAdd(stats + 2, n.tris);
  atomicAdd(stats + 3, n.sph);
  atomicAdd(stats + 4, n.rays);
}

template <bool kCount>
__global__ void __launch_bounds__(TRAV_THREADS)
    trace_records_kernel(Clusters c, Frame f, int* __restrict__ ids, int* __restrict__ occ,
                         float* __restrict__ tb, unsigned long long* stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f.n_pix) return;
  Counts n{0, 0, 0, 0, 0};
  const CameraRay r = raygen(c.s, f, f.off + i);
  whitted_records<kCount>(c, r.o, r.d, true, f.max_depth, f.shadows, ids + i, occ + i, tb + i,
                          f.n_pix, n);
  if (kCount) flush(stats, n);
}

template <bool kCount>
__global__ void __launch_bounds__(TRAV_THREADS)
    trace_bounce_kernel(Clusters c, const float* __restrict__ o, const float* __restrict__ d,
                        const unsigned char* __restrict__ alive, int n_live, int shadows,
                        int n_rays, int* __restrict__ ids, int* __restrict__ occ,
                        float* __restrict__ tb, unsigned long long* stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Counts n{0, 0, 0, 0, 0};
  const bool live = i < n_live && alive[i] != 0;
  const V3 oi{o[3LL * i], o[3LL * i + 1], o[3LL * i + 2]};
  const V3 di{d[3LL * i], d[3LL * i + 1], d[3LL * i + 2]};
  whitted_records<kCount>(c, oi, di, live, 0, shadows, ids + i, occ + i, tb + i, n_rays, n);
  if (kCount) flush(stats, n);
}

template <bool kCount>
__global__ void __launch_bounds__(TRAV_THREADS)
    trace_shadows_kernel(Clusters c, const float* __restrict__ p, const float* __restrict__ p_off,
                         const unsigned char* __restrict__ alive, int n_live, int n_rays,
                         int* __restrict__ occ, unsigned long long* stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Counts n{0, 0, 0, 0, 0};
  int bits = 0;
  if (i < n_live && alive[i] != 0) {
    const V3 pi{p[3LL * i], p[3LL * i + 1], p[3LL * i + 2]};
    const V3 qi{p_off[3LL * i], p_off[3LL * i + 1], p_off[3LL * i + 2]};
    bits = shadow_bits<kCount>(c, pi, qi, n);
  }
  occ[i] = bits;
  if (kCount) flush(stats, n);
}

inline Clusters make_clusters(const void* tri_forms, const void* tri_attrs, const void* boxes,
                              const void* children, const void* sph_forms,
                              const void* sph_attrs, const void* glob, int n_clusters, int leaf,
                              int n_sph, int n_lights, int n_tris) {
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                nullptr, static_cast<const float*>(glob), n_clusters * leaf, n_sph, n_lights};
  return Clusters{s,
                  static_cast<const float*>(tri_attrs),
                  static_cast<const float4*>(boxes),
                  static_cast<const int2*>(children),
                  static_cast<const float*>(sph_attrs),
                  n_clusters,
                  leaf,
                  n_tris};
}

}  // namespace tpurt

extern "C" {

// Each launches on `stream` and returns cudaGetLastError().  Outputs are
// allocated by the caller; `stats`, when not null, points at five zeroed
// 64-bit counters and selects the counting instantiation.

// ids, occ (i32) and tbest (f32), each (max_depth + 1, n_pix), of flat pixels
// [off, off + n_pix) of the height x width image.
int tpurt_trace_records(const void* tri_forms, const void* tri_attrs, const void* boxes,
                        const void* children, const void* sph_forms, const void* sph_attrs,
                        const void* glob, int n_clusters, int leaf, int n_sph, int n_lights,
                        int n_tris, void* ids, void* occ, void* tbest, void* stats, int height,
                        int width, float aspect, int max_depth, int shadows, int off, int n_pix,
                        void* stream) {
  using namespace tpurt;
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const Clusters c = make_clusters(tri_forms, tri_attrs, boxes, children, sph_forms, sph_attrs,
                                   glob, n_clusters, leaf, n_sph, n_lights, n_tris);
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int blocks = (n_pix + TRAV_THREADS - 1) / TRAV_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) {
    trace_records_kernel<true><<<blocks, TRAV_THREADS, 0, st>>>(
        c, f, static_cast<int*>(ids), static_cast<int*>(occ), static_cast<float*>(tbest),
        static_cast<unsigned long long*>(stats));
  } else {
    trace_records_kernel<false><<<blocks, TRAV_THREADS, 0, st>>>(
        c, f, static_cast<int*>(ids), static_cast<int*>(occ), static_cast<float*>(tbest),
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// one depth over rays o, d (n, 3) f32; alive (n,) bytes; rays at index >=
// n_live are dead too.  ids, occ, tbest are (n,).
int tpurt_trace_bounce(const void* tri_forms, const void* tri_attrs, const void* boxes,
                       const void* children, const void* sph_forms, const void* sph_attrs,
                       const void* glob, int n_clusters, int leaf, int n_sph, int n_lights,
                       int n_tris, const void* o, const void* d, const void* alive, int n_live,
                       void* ids, void* occ, void* tbest, void* stats, int shadows, int n,
                       void* stream) {
  using namespace tpurt;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Clusters c = make_clusters(tri_forms, tri_attrs, boxes, children, sph_forms, sph_attrs,
                                   glob, n_clusters, leaf, n_sph, n_lights, n_tris);
  const int blocks = (n + TRAV_THREADS - 1) / TRAV_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) {
    trace_bounce_kernel<true><<<blocks, TRAV_THREADS, 0, st>>>(
        c, static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const unsigned char*>(alive), n_live, shadows, n, static_cast<int*>(ids),
        static_cast<int*>(occ), static_cast<float*>(tbest),
        static_cast<unsigned long long*>(stats));
  } else {
    trace_bounce_kernel<false><<<blocks, TRAV_THREADS, 0, st>>>(
        c, static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const unsigned char*>(alive), n_live, shadows, n, static_cast<int*>(ids),
        static_cast<int*>(occ), static_cast<float*>(tbest), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// occlusion bits (n,) i32 of hit points p with offset origins p_off, (n, 3) f32
int tpurt_trace_shadows(const void* tri_forms, const void* tri_attrs, const void* boxes,
                        const void* children, const void* sph_forms, const void* sph_attrs,
                        const void* glob, int n_clusters, int leaf, int n_sph, int n_lights,
                        int n_tris, const void* p, const void* p_off, const void* alive,
                        int n_live, void* occ, void* stats, int n, void* stream) {
  using namespace tpurt;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Clusters c = make_clusters(tri_forms, tri_attrs, boxes, children, sph_forms, sph_attrs,
                                   glob, n_clusters, leaf, n_sph, n_lights, n_tris);
  const int blocks = (n + TRAV_THREADS - 1) / TRAV_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) {
    trace_shadows_kernel<true><<<blocks, TRAV_THREADS, 0, st>>>(
        c, static_cast<const float*>(p), static_cast<const float*>(p_off),
        static_cast<const unsigned char*>(alive), n_live, n, static_cast<int*>(occ),
        static_cast<unsigned long long*>(stats));
  } else {
    trace_shadows_kernel<false><<<blocks, TRAV_THREADS, 0, st>>>(
        c, static_cast<const float*>(p), static_cast<const float*>(p_off),
        static_cast<const unsigned char*>(alive), n_live, n, static_cast<int*>(occ), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
