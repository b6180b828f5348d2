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
// has a thread of its own, and the structure it walks (packc.py) has three
// levels of boxes, all refit every frame:
// * a 4-wide upper level: the frozen binary tree over consecutive ranges of
//   clusters (accel/clusters.py:build_tree) collapsed two levels into one
//   (build_wide).  A node holds its up to four children's boxes side by side;
//   the thread tests all four and pushes the survivors far to near, so that
//   the nearest is popped next, and drops a popped entry whose distance
//   exceeds the best hit so far;
// * inside a cluster of 128 slots, 8 groups of 16 consecutive slots with a
//   box each.  The slots come ordered by a split continued inside the cluster
//   (accel/clusters.py:slot_order), so a group is compact, not a slab.
//   Closest hit visits the admitted groups nearest first and stops at the
//   first one that starts beyond the best hit; any-hit visits them in order;
// * the 16 triangles of a group, with the phase-1 kernels' Baldwin-Weber test
//   (megakernel_common.cuh: tri_t, sph_t); an any-hit ray returns at the
//   first occluder.
// The stack lives in shared memory, entry k of a thread at k * TRAV_THREADS +
// threadIdx.x (no bank conflicts), MAX_STACK entries, which build_wide's
// bound on the 4-wide tree must not exceed (traversal.py:_check_limits).
// trace_records gives each warp an 8 x 4 tile of pixels, so that its rays
// enter the same clusters and groups; records are written in image order.
//
// The records contract (traversal.py states it through the plain versions):
// least t in (T_MIN, T_MAX); at equal t the smaller global id wins; a lane is
// live at depth d only if every earlier depth hit a reflective material; dead
// and missing lanes get id -1, occ 0, t T_NONE; a shadow ray starts at
// p + eps n, points along (light - p) / dist and is tested in
// (T_MIN, dist - eps).  Boxes only ever skip work, so the order of visits
// cannot change a record: every box is widened by packc.BOX_MARGIN (the box
// test never rejects a hit the triangle test would accept), a box is skipped
// only when it starts strictly beyond the best hit (hits at equal t still
// compete), and a group of pad slots only, which repeat a triangle of another
// group, gets a box that no ray enters.
//
// What bounds it on an H100: FP32 ALU work and divergence, not bytes.  A ray
// makes some tens of triangle tests of about 40 operations on 48 bytes that
// neighbouring threads mostly share through L1 and L2, and the records are
// 12 bytes a depth.  Full FP32 with -fmad=false, so that kernel and plain
// version agree to the bit; no tensor cores.
//
// The counting instantiation (kCount) adds up, per launch: box tests of the
// upper level, clusters entered, group box tests, triangle tests, sphere
// tests, rays traced.  The timed instantiation carries none of it.

#include "megakernel_common.cuh"

namespace tpurt {

// attribute columns (tpurt_torch/kernels/packc.py)
constexpr int TROWS = 16;
constexpr int R_N0 = 0, R_N1 = 3, R_N2 = 6, R_GID = 9, R_CENTER = 10, R_REFL = 14;

constexpr int GROUP = 16;       // slots of a group (packc.py: GROUP)
constexpr int MAX_GROUPS = 8;   // groups of a cluster at most (traversal.py: MAX_GROUPS)
constexpr int MAX_STACK = 32;   // traversal.py: MAX_STACK
constexpr int TRAV_THREADS = 128;
constexpr int TILE_W = 8, TILE_H = 4;  // trace_records: the pixels of a warp
constexpr int BLOCK_W = TILE_W * (TRAV_THREADS / 32);  // a block: 4 tiles side by side

// a child reference of the 4-wide level: >= 0 a node, <= -2 cluster -2 - ref
constexpr int NO_CHILD = -1;

struct Clusters {
  Scene s;                            // tri: (C * leaf, 3) forms; sph; glob; attrs unused
  const float* __restrict__ tattr;    // (C * leaf, TROWS)
  const float4* __restrict__ boxes;   // (2C - 1, 2): box 0 holds every cluster
  const float4* __restrict__ wide;    // (N4, 4, 2): the children's boxes of each node
  const int4* __restrict__ wide_children;  // (N4): references, NO_CHILD where none
  const float4* __restrict__ groups;  // (C * leaf / GROUP, 2)
  const float* __restrict__ sattr;    // (S, TROWS)
  int n_clusters, leaf, n_tris, n_groups;
};

struct Counts {
  unsigned long long nodes, clusters, groups, tris, sph, rays;
};

struct ClusterHit {
  float t, u, v;
  int gid;              // global id, -1 for a miss
  const float* attr;    // the winner's attribute row
};

// a thread's stack in shared memory: entry k at ref[k * TRAV_THREADS]
struct Stack {
  int* ref;
  float* t;
};

__shared__ int stack_ref[MAX_STACK * TRAV_THREADS];
__shared__ float stack_t[MAX_STACK * TRAV_THREADS];

__device__ __forceinline__ Stack thread_stack() {
  return {stack_ref + threadIdx.x, stack_t + threadIdx.x};
}

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

__device__ __forceinline__ void order2(float& ea, float& eb, int& ra, int& rb) {
  if (eb < ea) {
    const float e = ea;
    ea = eb;
    eb = e;
    const int r = ra;
    ra = rb;
    rb = r;
  }
}

// test the four children of node `node` against [0, tmax]; push the admitted
// ones far to near.  Returns the new stack size.
template <bool kCount>
__device__ __forceinline__ int push_children(const Clusters& c, int node, V3 o, V3 inv, float tmax,
                                             Stack st, int sp, Counts& n) {
  const int4 ch = __ldg(c.wide_children + node);
  float e0 = box_entry(c.wide, 4 * node, o, inv, tmax);
  float e1 = box_entry(c.wide, 4 * node + 1, o, inv, tmax);
  float e2 = box_entry(c.wide, 4 * node + 2, o, inv, tmax);
  float e3 = box_entry(c.wide, 4 * node + 3, o, inv, tmax);
  int r0 = ch.x, r1 = ch.y, r2 = ch.z, r3 = ch.w;
  if (kCount) n.nodes += (r0 != NO_CHILD) + (r1 != NO_CHILD) + (r2 != NO_CHILD) + (r3 != NO_CHILD);
  // a sorting network: e0 <= e1 <= e2 <= e3 (an empty child's box is never
  // entered: its +inf stays out)
  order2(e0, e1, r0, r1);
  order2(e2, e3, r2, r3);
  order2(e0, e2, r0, r2);
  order2(e1, e3, r1, r3);
  order2(e1, e2, r1, r2);
  if (e3 <= tmax) {
    st.ref[sp * TRAV_THREADS] = r3;
    st.t[sp * TRAV_THREADS] = e3;
    ++sp;
  }
  if (e2 <= tmax) {
    st.ref[sp * TRAV_THREADS] = r2;
    st.t[sp * TRAV_THREADS] = e2;
    ++sp;
  }
  if (e1 <= tmax) {
    st.ref[sp * TRAV_THREADS] = r1;
    st.t[sp * TRAV_THREADS] = e1;
    ++sp;
  }
  if (e0 <= tmax) {
    st.ref[sp * TRAV_THREADS] = r0;
    st.t[sp * TRAV_THREADS] = e0;
    ++sp;
  }
  return sp;
}

// the stack with the root node on it if the ray enters the scene's box
__device__ __forceinline__ int push_root(const Clusters& c, V3 o, V3 inv, float tmax, Stack st) {
  const float te = box_entry(c.boxes, 0, o, inv, tmax);
  if (te > tmax) return 0;
  st.ref[0] = 0;
  st.t[0] = te;
  return 1;
}

// closest hit over the GROUP slots from slot `first`
template <bool kCount>
__device__ __forceinline__ void closest_in_group(const Clusters& c, int first, V3 o, V3 d,
                                                 ClusterHit& h, Counts& n) {
  if (kCount) n.tris += GROUP;
#pragma unroll 4
  for (int s = first; s < first + GROUP; ++s) {
    float u, v;
    const float t = tri_t(c.s, s, o, d, u, v);
    if (t < h.t) {
      const float* a = c.tattr + static_cast<long long>(s) * TROWS;
      h = {t, u, v, gid_of(a), a};
    } else if (t == h.t && t < T_NONE) {
      const float* a = c.tattr + static_cast<long long>(s) * TROWS;
      const int g = gid_of(a);
      if (g < h.gid) h = {t, u, v, g, a};
    }
  }
}

// nearest hit over the groups of cluster cl that start within h.t, nearest
// group first
template <bool kCount>
__device__ __forceinline__ void closest_in_cluster(const Clusters& c, int cl, V3 o, V3 d, V3 inv,
                                                   ClusterHit& h, Counts& n) {
  const int g0 = cl * c.n_groups;
  float ge[MAX_GROUPS];
  unsigned mask = 0;
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    ge[g] = __int_as_float(0x7f800000);
    if (g < c.n_groups) {
      ge[g] = box_entry(c.groups, g0 + g, o, inv, h.t);
      if (ge[g] <= h.t) mask |= 1u << g;
    }
  }
  if (kCount) {
    n.clusters += 1;
    n.groups += c.n_groups;
  }
  while (mask != 0) {
    int best = __ffs(mask) - 1;
    float eb = __int_as_float(0x7f800000);
#pragma unroll
    for (int g = 0; g < MAX_GROUPS; ++g) {
      if (((mask >> g) & 1u) && ge[g] < eb) {
        eb = ge[g];
        best = g;
      }
    }
    if (eb > h.t) break;  // every group left starts beyond the best hit
    mask &= ~(1u << best);
    closest_in_group<kCount>(c, (g0 + best) * GROUP, o, d, h, n);
  }
}

// nearest hit over the resident spheres and every cluster
template <bool kCount>
__device__ inline ClusterHit closest_hit(const Clusters& c, V3 o, V3 d, Stack st, Counts& n) {
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
  if (kCount) n.nodes += 1;
  int sp = push_root(c, o, inv, h.t, st);
  while (sp > 0) {
    --sp;
    const int ref = st.ref[sp * TRAV_THREADS];
    if (st.t[sp * TRAV_THREADS] > h.t) continue;  // a nearer hit was found since the push
    if (ref < 0) {
      closest_in_cluster<kCount>(c, -2 - ref, o, d, inv, h, n);
    } else {
      sp = push_children<kCount>(c, ref, o, inv, h.t, st, sp, n);
    }
  }
  return h;
}

// any primitive at t in (T_MIN, tmax) along the ray
template <bool kCount>
__device__ inline bool any_hit(const Clusters& c, V3 o, V3 d, float tmax, Stack st, Counts& n) {
  if (kCount) n.rays += 1;
  const float oo = dot(o, o);
  const float od = dot(o, d);
  for (int j = 0; j < c.s.n_sph; ++j) {
    bool first;
    if (kCount) n.sph += 1;
    if (sph_t(c.s, j, o, d, oo, od, first) < tmax) return true;
  }
  const V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  if (kCount) n.nodes += 1;
  int sp = push_root(c, o, inv, tmax, st);
  while (sp > 0) {
    const int ref = st.ref[--sp * TRAV_THREADS];
    if (ref >= 0) {
      sp = push_children<kCount>(c, ref, o, inv, tmax, st, sp, n);
      continue;
    }
    const int g0 = (-2 - ref) * c.n_groups;
    if (kCount) {
      n.clusters += 1;
      n.groups += c.n_groups;
    }
    for (int g = g0; g < g0 + c.n_groups; ++g) {
      if (box_entry(c.groups, g, o, inv, tmax) > tmax) continue;
      if (kCount) n.tris += GROUP;
#pragma unroll 4
      for (int s = g * GROUP; s < (g + 1) * GROUP; ++s) {
        float u, v;
        if (tri_t(c.s, s, o, d, u, v) < tmax) return true;
      }
    }
  }
  return false;
}

// bit l: light l is blocked from p, the ray starting at p_off
template <bool kCount>
__device__ inline int shadow_bits(const Clusters& c, V3 p, V3 p_off, Stack st, Counts& n) {
  const float* g = c.s.glob;
  int bits = 0;
  for (int li = 0; li < c.s.n_lights; ++li) {
    const V3 to_l = sub(ld3(g + NGLOB_BASE + 3 * li), p);
    const float dist = sqrtf(dot(to_l, to_l));
    const V3 ldir = scale(to_l, 1.0f / fmaxf(dist, 1e-20f));
    if (any_hit<kCount>(c, p_off, ldir, dist - RAY_OFFSET_EPS, st, n)) bits |= 1 << li;
  }
  return bits;
}

// records of one path for depths 0..max_depth, written at ids[k * stride] etc.
template <bool kCount>
__device__ inline void whitted_records(const Clusters& c, V3 o, V3 d, bool alive, int max_depth,
                                       int shadows, int* ids, int* occ, float* tb,
                                       long long stride, Stack st, Counts& n) {
  for (int depth = 0; depth <= max_depth; ++depth) {
    int id = -1, bits = 0;
    float tbest = T_NONE;
    if (alive) {
      const ClusterHit h = closest_hit<kCount>(c, o, d, st, n);
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
        if (shadows) bits = shadow_bits<kCount>(c, p, p_off, st, n);
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
  atomicAdd(stats + 2, n.groups);
  atomicAdd(stats + 3, n.tris);
  atomicAdd(stats + 4, n.sph);
  atomicAdd(stats + 5, n.rays);
}

// a block covers BLOCK_W x TILE_H pixels of rows row0.., blocks_x to a row
template <bool kCount>
__global__ void __launch_bounds__(TRAV_THREADS)
    trace_records_kernel(Clusters c, Frame f, int row0, int blocks_x, int* __restrict__ ids,
                         int* __restrict__ occ, float* __restrict__ tb,
                         unsigned long long* stats) {
  const Stack st = thread_stack();
  const int lane = threadIdx.x & 31;
  const int bx = blockIdx.x % blocks_x, by = blockIdx.x / blocks_x;
  const int col = bx * BLOCK_W + (threadIdx.x >> 5) * TILE_W + lane % TILE_W;
  const int row = row0 + by * TILE_H + lane / TILE_W;
  const long long i = static_cast<long long>(row) * f.width + col - f.off;
  if (col >= f.width || i < 0 || i >= f.n_pix) return;
  Counts n{0, 0, 0, 0, 0, 0};
  const CameraRay r = raygen(c.s, f, f.off + static_cast<int>(i));
  whitted_records<kCount>(c, r.o, r.d, true, f.max_depth, f.shadows, ids + i, occ + i, tb + i,
                          f.n_pix, st, n);
  if (kCount) flush(stats, n);
}

template <bool kCount>
__global__ void __launch_bounds__(TRAV_THREADS)
    trace_bounce_kernel(Clusters c, const float* __restrict__ o, const float* __restrict__ d,
                        const unsigned char* __restrict__ alive, int n_live, int shadows,
                        int n_rays, int* __restrict__ ids, int* __restrict__ occ,
                        float* __restrict__ tb, unsigned long long* stats) {
  const Stack st = thread_stack();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Counts n{0, 0, 0, 0, 0, 0};
  const bool live = i < n_live && alive[i] != 0;
  const V3 oi{o[3LL * i], o[3LL * i + 1], o[3LL * i + 2]};
  const V3 di{d[3LL * i], d[3LL * i + 1], d[3LL * i + 2]};
  whitted_records<kCount>(c, oi, di, live, 0, shadows, ids + i, occ + i, tb + i, n_rays, st, n);
  if (kCount) flush(stats, n);
}

template <bool kCount>
__global__ void __launch_bounds__(TRAV_THREADS)
    trace_shadows_kernel(Clusters c, const float* __restrict__ p, const float* __restrict__ p_off,
                         const unsigned char* __restrict__ alive, int n_live, int n_rays,
                         int* __restrict__ occ, unsigned long long* stats) {
  const Stack st = thread_stack();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Counts n{0, 0, 0, 0, 0, 0};
  int bits = 0;
  if (i < n_live && alive[i] != 0) {
    const V3 pi{p[3LL * i], p[3LL * i + 1], p[3LL * i + 2]};
    const V3 qi{p_off[3LL * i], p_off[3LL * i + 1], p_off[3LL * i + 2]};
    bits = shadow_bits<kCount>(c, pi, qi, st, n);
  }
  occ[i] = bits;
  if (kCount) flush(stats, n);
}

inline Clusters make_clusters(const void* tri_forms, const void* tri_attrs, const void* boxes,
                              const void* wide_boxes, const void* wide_children,
                              const void* group_boxes, const void* sph_forms,
                              const void* sph_attrs, const void* glob, int n_clusters, int leaf,
                              int n_sph, int n_lights, int n_tris) {
  const Scene s{static_cast<const float4*>(tri_forms), static_cast<const float4*>(sph_forms),
                nullptr, static_cast<const float*>(glob), n_clusters * leaf, n_sph, n_lights};
  return Clusters{s,
                  static_cast<const float*>(tri_attrs),
                  static_cast<const float4*>(boxes),
                  static_cast<const float4*>(wide_boxes),
                  static_cast<const int4*>(wide_children),
                  static_cast<const float4*>(group_boxes),
                  static_cast<const float*>(sph_attrs),
                  n_clusters,
                  leaf,
                  n_tris,
                  leaf / GROUP};
}

}  // namespace tpurt

extern "C" {

// Each launches on `stream` and returns cudaGetLastError().  Outputs are
// allocated by the caller; `stats`, when not null, points at six zeroed
// 64-bit counters and selects the counting instantiation.  The tables are
// packc.py's: boxes (2C - 1, 2, 4), wide_boxes (N4, 4, 2, 4), wide_children
// (N4, 4) i32, group_boxes (C * leaf / 16, 2, 4); leaf is a multiple of 16 of
// at most 128.

// ids, occ (i32) and tbest (f32), each (max_depth + 1, n_pix), of flat pixels
// [off, off + n_pix) of the height x width image.
int tpurt_trace_records(const void* tri_forms, const void* tri_attrs, const void* boxes,
                        const void* wide_boxes, const void* wide_children,
                        const void* group_boxes, const void* sph_forms, const void* sph_attrs,
                        const void* glob, int n_clusters, int leaf, int n_sph, int n_lights,
                        int n_tris, void* ids, void* occ, void* tbest, void* stats, int height,
                        int width, float aspect, int max_depth, int shadows, int off, int n_pix,
                        void* stream) {
  using namespace tpurt;
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const Clusters c = make_clusters(tri_forms, tri_attrs, boxes, wide_boxes, wide_children,
                                   group_boxes, sph_forms, sph_attrs, glob, n_clusters, leaf,
                                   n_sph, n_lights, n_tris);
  const Frame f{height, width, aspect, max_depth, shadows, off, n_pix};
  const int row0 = off / width;
  const int rows = (off + n_pix - 1) / width - row0 + 1;
  const int blocks_x = (width + BLOCK_W - 1) / BLOCK_W;
  const int blocks = blocks_x * ((rows + TILE_H - 1) / TILE_H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) {
    trace_records_kernel<true><<<blocks, TRAV_THREADS, 0, st>>>(
        c, f, row0, blocks_x, static_cast<int*>(ids), static_cast<int*>(occ),
        static_cast<float*>(tbest), static_cast<unsigned long long*>(stats));
  } else {
    trace_records_kernel<false><<<blocks, TRAV_THREADS, 0, st>>>(
        c, f, row0, blocks_x, static_cast<int*>(ids), static_cast<int*>(occ),
        static_cast<float*>(tbest), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// one depth over rays o, d (n, 3) f32; alive (n,) bytes; rays at index >=
// n_live are dead too.  ids, occ, tbest are (n,).
int tpurt_trace_bounce(const void* tri_forms, const void* tri_attrs, const void* boxes,
                       const void* wide_boxes, const void* wide_children,
                       const void* group_boxes, const void* sph_forms, const void* sph_attrs,
                       const void* glob, int n_clusters, int leaf, int n_sph, int n_lights,
                       int n_tris, const void* o, const void* d, const void* alive, int n_live,
                       void* ids, void* occ, void* tbest, void* stats, int shadows, int n,
                       void* stream) {
  using namespace tpurt;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Clusters c = make_clusters(tri_forms, tri_attrs, boxes, wide_boxes, wide_children,
                                   group_boxes, sph_forms, sph_attrs, glob, n_clusters, leaf,
                                   n_sph, n_lights, n_tris);
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
                        const void* wide_boxes, const void* wide_children,
                        const void* group_boxes, const void* sph_forms, const void* sph_attrs,
                        const void* glob, int n_clusters, int leaf, int n_sph, int n_lights,
                        int n_tris, const void* p, const void* p_off, const void* alive,
                        int n_live, void* occ, void* stats, int n, void* stream) {
  using namespace tpurt;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Clusters c = make_clusters(tri_forms, tri_attrs, boxes, wide_boxes, wide_children,
                                   group_boxes, sph_forms, sph_attrs, glob, n_clusters, leaf,
                                   n_sph, n_lights, n_tris);
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
