// The reverse sweep shared by the phase-1 backward kernels (megakernel_bwd.cu,
// megabwd_hand.cu), and the tables their blocks sum cotangents into.
//
// The adjoint is the hand derivation of tpurt/kernels/megabwd.py:395-716,
// written per thread: one depth at a time from the last visited depth back to
// the camera ray, with closed forms for Phong and Whitted shading, normalize,
// reflect, the winner's Baldwin-Weber forms and the sphere's quadratic root.
// The winner's forms are evaluated again from its row (six dot products), not
// kept; the TPU's one-hot matmul transposes become adds into the winner's
// rows.  tpurt_torch/kernels/megabwd.py:_hand_chunk is the same sweep in plain
// PyTorch, line for line.
//
// Subgradients at ties follow megabwd.py: the clip passes the seed on the
// closed interval, max(x, 0) passes nothing unless x > 0, the light distance
// passes nothing unless dist > 1e-20; topology and visibility are fixed.
//
// Summing, in a fixed order.  One flat table of n floats, [globals |
// tri_forms | sph_forms | attrs].  Each warp of a block owns a copy of it in
// shared memory and is the only writer of its copy, so an add is a plain
// load-add-store.  A depth's values reach the copy in passes of at most 16
// rows through the warp's scratch (ROWS x PITCH floats): each lane writes its
// value of row r at column `lane`; lane k sums row k & 15 over the 16 lanes
// of its half in lane order (four float4 loads), one shuffle adds the two
// halves, and lane k < 16 adds the sum at row k's table index.  The passes of
// a depth: ambient and the first two lights (one more for each further pair
// of lights); the winner's attribute and form rows, 32 values in two passes,
// once for each winner among the warp's lanes (__match_any_sync groups them;
// the lanes of other groups write zeros); and once a pixel the camera's 12
// values.  The block then adds
// its warps' copies in warp order into its row of partials, and reduce_rows
// adds the rows in block order: every bit of a result depends only on the
// pixels and the launch shape.  No shared-memory atomicAdd: on this card a
// float one is a compare-and-swap loop, and with 8 warps on the same ~50
// addresses it cost 0.95 of K4's 1.61 ms at config 3 (PERF.md §6).
//
// A table whose copies do not fit (megakernel.py:takes_fixed_order) takes the
// same passes, but lane k adds its sum atomically into one zeroed row in
// device memory, so the last bits of its sums vary from run to run.
//
// A block's dynamic shared memory, in order: the warps' scratch; the
// residuals and occlusion bits of max_depth + 1 depths, [depth][thread]; the
// warps' copies of the table on the fixed-order path (phase1_shared_bytes).

#pragma once

#include "megakernel_common.cuh"

namespace tpurt {

constexpr int MAX_DEPTHS = 16;  // depths a backward kernel keeps: max_depth + 1 <= 16
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;   // blocks an SM the kernels keep: at most 128 registers
constexpr int ROWS = 16;        // rows of a warp's scratch: the values of one pass
constexpr int PITCH = 36;       // floats a scratch row: the float4 reads of 8 lanes
                                // (rows k..k+7 at one column) hit distinct banks
constexpr int RES_WORDS = sizeof(Residual) / 4;

// slots of the winner's 32 values (winner_addr): ka kd ks shin refl, then the
// vertex normals (a sphere's centre in the first three), then the form rows
constexpr int R_KA = 0, R_SHIN = 9, R_REFL = 10, R_N = 11, R_FORM = 20, R_ALL = 32;
static_assert(A_KD == A_KA + 3 && A_KS == A_KA + 6 && A_SHIN == A_KA + 9 &&
                  A_REFL == A_KA + 10 && A_N1 == A_N0 + 3 && A_N2 == A_N0 + 6,
              "attribute columns that winner_addr takes as runs");

__host__ __device__ inline int table_floats(int n_tris, int n_sph, int n_lights) {
  return NGLOB_BASE + 6 * n_lights + 12 * n_tris + 8 * n_sph + ACOLS * (n_tris + n_sph);
}

// dynamic shared memory of a block (megakernel.py:phase1_shared_bytes)
__host__ __device__ inline long long phase1_shared_bytes(int n, int depths, int fixed) {
  return 4LL * (WARPS * ROWS * PITCH + static_cast<long long>(depths) * THREADS * (RES_WORDS + 1) +
                (fixed ? static_cast<long long>(WARPS) * n : 0LL));
}

// Lets `kernel` take the dynamic shared memory of an n-float table at
// `depths` depths (above 48 KB a kernel must ask); returns the bytes, or
// minus the CUDA error.
template <class Kernel>
inline int allow_shared(Kernel kernel, int n, int depths, int fixed) {
  const int bytes = static_cast<int>(phase1_shared_bytes(n, depths, fixed));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// blocks of `kernel` that an SM holds at once with that shared memory
template <class Kernel>
inline int occupancy(Kernel kernel, int n, int depths, int fixed, int* blocks) {
  const int bytes = allow_shared(kernel, n, depths, fixed);
  if (bytes < 0) return -bytes;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, bytes));
}

// The kernels come in two instances: kFixed, the tables summed in the
// warps' copies; and not, summed with atomic adds into the zeroed row in
// device memory.
struct Tables {
  float* copies;   // the block's WARPS copies (kFixed)
  float* acc;      // this warp's copy (kFixed)
  float* dev;      // the one zeroed row in device memory (otherwise)
  float* scratch;  // this warp's ROWS x PITCH floats
  int off_tri, off_sph, off_attr, n;
};

// a thread's place in its block's shared memory
struct Block {
  Tables tb;
  Residual* res;  // depth k at res[k * THREADS]
  int* occ;       // depth k at occ[k * THREADS]
};

// Every thread of the block calls this before its first pixel.
template <bool kFixed>
__device__ __forceinline__ Block block_begin(const Scene& s, const Frame& f, float4* smem4,
                                             float* partials) {
  float* smem = reinterpret_cast<float*>(smem4);
  const int depths = f.max_depth + 1;
  const int warp = threadIdx.x >> 5;
  Block b;
  Tables& tb = b.tb;
  tb.off_tri = NGLOB_BASE + 6 * s.n_lights;
  tb.off_sph = tb.off_tri + 12 * s.n_tris;
  tb.off_attr = tb.off_sph + 8 * s.n_sph;
  tb.n = table_floats(s.n_tris, s.n_sph, s.n_lights);
  tb.dev = partials;
  tb.scratch = smem + warp * ROWS * PITCH;
  float* rest = smem + WARPS * ROWS * PITCH;
  b.res = reinterpret_cast<Residual*>(rest) + threadIdx.x;
  rest += depths * THREADS * RES_WORDS;
  b.occ = reinterpret_cast<int*>(rest) + threadIdx.x;
  rest += depths * THREADS;
  tb.copies = rest;
  tb.acc = rest + warp * tb.n;
  if (kFixed) {
    for (int j = threadIdx.x; j < WARPS * tb.n; j += THREADS) rest[j] = 0.0f;
  }
  __syncthreads();
  return b;
}

// Every thread of the block calls this after its last pixel: the warps'
// copies, added in warp order, become the block's row of partials.
template <bool kFixed>
__device__ __forceinline__ void tables_end(const Tables& tb, float* partials) {
  if (!kFixed) return;
  __syncthreads();
  float* row = partials + static_cast<long long>(blockIdx.x) * tb.n;
  for (int j = threadIdx.x; j < tb.n; j += THREADS) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += tb.copies[w * tb.n + j];
    row[j] = sum;
  }
}

// The rows of a pass are written: sum each over the warp's 32 lanes in a
// fixed order, and lane k < 16 adds the sum of row k at table index `at`
// (nothing where at < 0).  All 32 lanes call this together.
template <bool kFixed>
__device__ __forceinline__ void flush(const Tables& tb, int at) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const float4* p =
      reinterpret_cast<const float4*>(tb.scratch + (lane & 15) * PITCH + (lane & 16));
  const float4 a = p[0], b = p[1], c = p[2], d = p[3];
  const float half = (((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w))) +
                     (((c.x + c.y) + (c.z + c.w)) + ((d.x + d.y) + (d.z + d.w)));
  const float sum = half + __shfl_xor_sync(FULL_WARP, half, 16);
  __syncwarp();
  if (lane < 16 && at >= 0) {
    if constexpr (kFixed) {
      tb.acc[at] += sum;
    } else {
      // atomicAdd here compiled to a shared-memory atomic on the row's
      // address (nvcc 12.8, sm_90a), which faults; the PTX names the space
      asm volatile("red.global.add.f32 [%0], %1;" ::"l"(tb.dev + at), "f"(sum) : "memory");
    }
  }
}

// table index of row `row` of light pass `pass`: rows 0-2 ambient (the first
// pass only), rows 3 + 6 q .. 8 + 6 q the position and colour of light
// 2 pass + q; -1 for a row that is not the pass's
__device__ __forceinline__ int light_addr(int row, int pass, int n_lights) {
  if (row < 3) return pass == 0 ? 12 + row : -1;
  const int li = 2 * pass + (row - 3) / 6, j = (row - 3) % 6;
  if (row >= 15 || li >= n_lights) return -1;
  return NGLOB_BASE + (j < 3 ? 3 * li + j : 3 * n_lights + 3 * li + j - 3);
}

// table index of slot `slot` of winner `win`'s 32 values; -1 for a slot that
// a sphere does not have
__device__ __forceinline__ int winner_addr(const Scene& s, const Tables& tb, int slot, int win) {
  const bool tri = win < s.n_tris;
  const int attr = tb.off_attr + win * ACOLS;
  if (slot < R_N) return attr + A_KA + slot;
  if (slot < R_FORM) {
    if (tri) return attr + A_N0 + slot - R_N;
    return slot < R_N + 3 ? attr + A_CENTER + slot - R_N : -1;
  }
  if (slot >= R_ALL) return -1;
  if (tri) return tb.off_tri + 12 * win + slot - R_FORM;
  return slot < R_FORM + 8 ? tb.off_sph + 8 * (win - s.n_tris) + slot - R_FORM : -1;
}

// adjoint of n = v * rsqrt(v.v + eps)
__device__ __forceinline__ V3 nrm_bwd(V3 v, V3 cot_n) {
  const float s = rsqrtf(dot(v, v) + NORMALIZE_EPS);
  const float vc = dot(v, cot_n);
  const float s3 = s * s * s;
  return sub(scale(cot_n, s), scale(v, s3 * vc));
}

// adjoint of r = m - 2 (m.n) n
__device__ __forceinline__ void refl_bwd(V3 m, V3 n, V3 cot_r, V3& cot_m, V3& cot_n) {
  const float ncr = dot(n, cot_r);
  const float mn = dot(m, n);
  cot_m = sub(cot_r, scale(n, 2.0f * ncr));
  cot_n = scale(add(scale(cot_r, mn), scale(m, ncr)), -2.0f);
}

// Sweep back over the depths a pixel visited and add its cotangents into the
// tables.  All 32 lanes of a warp call this together; a lane without a pixel
// passes nd = 0.  res[k * THREADS] holds the residuals of depth k and
// occ[k * stride] its occlusion bits; ca0..2 is the cotangent of the radiance
// before the clip.
template <bool kFixed>
__device__ __forceinline__ void sweep_reverse(const Scene& s, const Tables& tb,
                                              const Residual* res, int nd, const int* occ,
                                              long long stride, int shadows, float ca0,
                                              float ca1, float ca2, const CameraRay& cam) {
  const float* g = s.glob;
  const int L = s.n_lights;
  const int lane = threadIdx.x & 31;
  float* col = tb.scratch + lane;  // this lane's column of the scratch: row r at col[r * PITCH]
  const V3 ambient = ld3(g + 12);
  V3 cot_o{0.0f, 0.0f, 0.0f}, cot_d{0.0f, 0.0f, 0.0f};
  float cot_thr = 0.0f;
  const int kmax = __reduce_max_sync(FULL_WARP, nd);
  for (int k = kmax - 1; k >= 0; --k) {
    const int idx = k < nd ? res[k * THREADS].idx() : -1;
    const bool act = idx >= 0;  // a shaded point: the adjoint runs
    if (k < nd && !act) {
      // the path's last depth missed: accum += thr * background
      cot_thr = ca0 * BG0 + ca1 * BG1 + ca2 * BG2;
    }
    const unsigned lanes = __ballot_sync(FULL_WARP, act);
    if (lanes == 0u) continue;
    const bool is_tri = act && idx < s.n_tris;
    const float* a = s.attrs + static_cast<long long>(act ? idx : 0) * ACOLS;

    // this lane's values; they stay zero on a lane without a shaded point
    V3 o{}, d{}, p{}, n{}, view{}, ka{}, kd{}, ks{}, csh{};
    V3 nsrc{};  // what n normalises: the interpolated normal, or p - centre
    float t = 0.0f, u = 0.0f, v = 0.0f, w = 1.0f, thr = 0.0f, shin = 0.0f, refl_a = 0.0f;
    bool flip = false, first = false;
    int bits = 0;
    float col0 = 0.0f, col1 = 0.0f, col2 = 0.0f;
    V3 cot_n{}, cot_p{}, cot_view{};
    float c[R_ALL] = {};  // the winner's 32 values, slots R_KA .. R_FORM + 11

    if (act) {
      const Residual r = res[k * THREADS];
      o = r.o, d = r.d, t = r.t, u = r.u, v = r.v, thr = r.thr, first = r.first();
      bits = occ[k * stride];
      p = add(o, scale(d, t));
      if (is_tri) {
        w = 1.0f - u - v;
        nsrc = add(scale(ld3(a + A_N0), w), add(scale(ld3(a + A_N1), u), scale(ld3(a + A_N2), v)));
        const V3 ni = normalize(nsrc);
        flip = dot(ni, d) > 0.0f;
        n = flip ? neg(ni) : ni;
      } else {
        nsrc = sub(p, ld3(a + A_CENTER));
        n = normalize(nsrc);
      }
      ka = ld3(a + A_KA), kd = ld3(a + A_KD), ks = ld3(a + A_KS);
      shin = __ldg(a + A_SHIN);
      refl_a = __ldg(a + A_REFL);
      view = neg(d);
      c[R_REFL] = cot_thr * thr;                    // thr' = thr * refl
      csh = {ca0 * thr, ca1 * thr, ca2 * thr};      // accum += thr * colour
      col0 = ka.x * ambient.x, col1 = ka.y * ambient.y, col2 = ka.z * ambient.z;
    }

    // ambient (rows 0-2 of the first light pass), then the lights two at a
    // time (rows 3 + 6 q ..), one pass a pair
    col[0] = ka.x * csh.x, col[PITCH] = ka.y * csh.y, col[2 * PITCH] = ka.z * csh.z;
    const int light_passes = L > 0 ? (L + 1) / 2 : 1;
    for (int pass = 0; pass < light_passes; ++pass) {
#pragma unroll 1
      for (int q = 0; q < 2; ++q) {
        const int li = 2 * pass + q;
        float d_lpos[3] = {}, d_lcol[3] = {};
        if (act && li < L) {
          const V3 lpos = ld3(g + NGLOB_BASE + 3 * li);
          const V3 lcol = ld3(g + NGLOB_BASE + 3 * L + 3 * li);
          const V3 to_l = sub(lpos, p);
          const float dist2 = dot(to_l, to_l);
          const float dist = sqrtf(dist2);
          const float inv = 1.0f / fmaxf(dist, 1e-20f);
          const V3 ldir = scale(to_l, inv);
          const float raw_nl = dot(n, ldir);
          const float ndotl = fmaxf(raw_nl, 0.0f);
          const V3 mneg = neg(ldir);
          const V3 refl_l = reflect(mneg, n);
          const float raw_rv = dot(refl_l, view);
          const float rdotv = fmaxf(raw_rv, 0.0f);
          const float safe_rv = rdotv > 0.0f ? rdotv : 1.0f;
          const bool specmask = ndotl > 0.0f && rdotv > 0.0f;
          const float spec = specmask ? powf(safe_rv, shin) : 0.0f;
          const float vis = (shadows && ((bits >> li) & 1)) ? 0.0f : 1.0f;

          const float s0 = kd.x * ndotl + ks.x * spec;
          const float s1 = kd.y * ndotl + ks.y * spec;
          const float s2 = kd.z * ndotl + ks.z * spec;
          col0 = col0 + vis * lcol.x * s0;
          col1 = col1 + vis * lcol.y * s1;
          col2 = col2 + vis * lcol.z * s2;
          const V3 lc = {vis * lcol.x * csh.x, vis * lcol.y * csh.y, vis * lcol.z * csh.z};
          c[R_KA + 3] += lc.x * ndotl, c[R_KA + 4] += lc.y * ndotl, c[R_KA + 5] += lc.z * ndotl;
          c[R_KA + 6] += lc.x * spec, c[R_KA + 7] += lc.y * spec, c[R_KA + 8] += lc.z * spec;
          const float cot_ndotl = lc.x * kd.x + lc.y * kd.y + lc.z * kd.z;
          const float cot_spec = lc.x * ks.x + lc.y * ks.y + lc.z * ks.z;
          d_lcol[0] = vis * s0 * csh.x, d_lcol[1] = vis * s1 * csh.y, d_lcol[2] = vis * s2 * csh.z;

          // pow's two adjoints, both under the spec mask
          float cot_srv = 0.0f;
          if (specmask) {
            cot_srv = shin * powf(safe_rv, shin - 1.0f) * cot_spec;
            c[R_SHIN] += spec * logf(safe_rv) * cot_spec;
          }
          const float cot_raw_rv = raw_rv > 0.0f ? cot_srv : 0.0f;
          const V3 cot_refl_l = scale(view, cot_raw_rv);
          cot_view = add(cot_view, scale(refl_l, cot_raw_rv));
          V3 cot_m, cot_n_r;
          refl_bwd(mneg, n, cot_refl_l, cot_m, cot_n_r);
          const float cot_raw_nl = raw_nl > 0.0f ? cot_ndotl : 0.0f;
          cot_n = add(add(cot_n, cot_n_r), scale(ldir, cot_raw_nl));
          const V3 cot_ldir = add(neg(cot_m), scale(n, cot_raw_nl));
          const float cot_inv = dot(to_l, cot_ldir);
          const float cot_dist = dist > 1e-20f ? -(inv * inv) * cot_inv : 0.0f;
          const float cot_dist2 = dist2 > 0.0f ? cot_dist / (2.0f * dist) : 0.0f;
          const V3 cot_to_l = add(scale(cot_ldir, inv), scale(to_l, 2.0f * cot_dist2));
          d_lpos[0] = cot_to_l.x, d_lpos[1] = cot_to_l.y, d_lpos[2] = cot_to_l.z;
          cot_p = sub(cot_p, cot_to_l);
        }
        float* rows = col + (3 + 6 * q) * PITCH;
#pragma unroll
        for (int j = 0; j < 3; ++j) rows[j * PITCH] = d_lpos[j], rows[(3 + j) * PITCH] = d_lcol[j];
      }
      flush<kFixed>(tb, light_addr(lane, pass, L));
    }

    V3 cot_o_in{}, cot_d_in{};
    float cot_thr_in = cot_thr;  // a miss set it above; a dead lane keeps zero
    if (act) {
      cot_thr_in = cot_thr * refl_a + (ca0 * col0 + ca1 * col1 + ca2 * col2);
      c[R_KA] = ambient.x * csh.x, c[R_KA + 1] = ambient.y * csh.y, c[R_KA + 2] = ambient.z * csh.z;

      // the next ray: o' = p + eps n, d' = reflect(d, n); view = -d
      cot_p = add(cot_p, cot_o);
      cot_n = add(cot_n, scale(cot_o, RAY_OFFSET_EPS));
      V3 cot_n_r2;
      refl_bwd(d, n, cot_d, cot_d_in, cot_n_r2);
      cot_n = add(cot_n, cot_n_r2);
      cot_d_in = sub(cot_d_in, cot_view);

      float cot_u = 0.0f, cot_v = 0.0f;
      if (is_tri) {
        // the vertex normals, read again rather than kept through the lights
        const V3 n0 = ld3(a + A_N0), n1 = ld3(a + A_N1), n2 = ld3(a + A_N2);
        const V3 cot_g = nrm_bwd(nsrc, flip ? neg(cot_n) : cot_n);
        c[R_N] = cot_g.x * w, c[R_N + 1] = cot_g.y * w, c[R_N + 2] = cot_g.z * w;
        c[R_N + 3] = cot_g.x * u, c[R_N + 4] = cot_g.y * u, c[R_N + 5] = cot_g.z * u;
        c[R_N + 6] = cot_g.x * v, c[R_N + 7] = cot_g.y * v, c[R_N + 8] = cot_g.z * v;
        cot_u = dot(sub(n1, n0), cot_g);
        cot_v = dot(sub(n2, n0), cot_g);
      } else {
        const V3 cot_psub = nrm_bwd(nsrc, cot_n);
        cot_p = add(cot_p, cot_psub);
        c[R_N] = -cot_psub.x, c[R_N + 1] = -cot_psub.y, c[R_N + 2] = -cot_psub.z;  // centre
      }

      // p = o + t d
      cot_o_in = cot_p;
      const float cot_t = dot(cot_p, d);
      cot_d_in = add(cot_d_in, scale(cot_p, t));

      // the winner's forms, evaluated again from its row
      if (is_tri) {
        const float4 fn = __ldg(s.tri + 3 * idx);
        const float4 fu = __ldg(s.tri + 3 * idx + 1);
        const float4 fv = __ldg(s.tri + 3 * idx + 2);
        const float no = form_o(fn, o);
        const float ndd = form_d(fn, d);
        const bool good = fabsf(ndd) >= MT_DET_EPS;
        const float safe_nd = good ? ndd : 1.0f;
        const float t_tri = -no / safe_nd;
        const float cot_t_tri = cot_t + form_d(fu, d) * cot_u + form_d(fv, d) * cot_v;
        const float cot_no = good ? -cot_t_tri / safe_nd : 0.0f;
        const float cot_nd = good ? (-t_tri / safe_nd) * cot_t_tri : 0.0f;
        const float cot_ud = t_tri * cot_u;
        const float cot_vd = t_tri * cot_v;
        // cot (x) (o, 1) and cot (x) d share a form's three xyz columns
        const float co[3] = {cot_no, cot_u, cot_v};
        const float cd[3] = {cot_nd, cot_ud, cot_vd};
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          c[R_FORM + 4 * r + 0] = co[r] * o.x + cd[r] * d.x;
          c[R_FORM + 4 * r + 1] = co[r] * o.y + cd[r] * d.y;
          c[R_FORM + 4 * r + 2] = co[r] * o.z + cd[r] * d.z;
          c[R_FORM + 4 * r + 3] = co[r];
        }
        cot_o_in = add(cot_o_in, add(scale(xyz(fn), cot_no),
                                     add(scale(xyz(fu), cot_u), scale(xyz(fv), cot_v))));
        cot_d_in = add(cot_d_in, add(scale(xyz(fn), cot_nd),
                                     add(scale(xyz(fu), cot_ud), scale(xyz(fv), cot_vd))));
      } else {
        // t = -b -+ sqrt(b^2 - cterm), the root the forward chose
        const int j = idx - s.n_tris;
        const float4 fc = __ldg(s.sph + 2 * j);
        const float4 fd = __ldg(s.sph + 2 * j + 1);
        const float b = dot(o, d) - form_d(fd, d);
        const float cterm = dot(o, o) + form_o(fc, o);
        const float disc = b * b - cterm;
        const bool has = disc > 0.0f;
        const float sqv = sqrtf(has ? disc : 1.0f);
        const float cot_sq = first ? -cot_t : cot_t;
        const float cot_disc = has ? cot_sq / (2.0f * sqv) : 0.0f;
        const float cot_b = -cot_t + 2.0f * b * cot_disc;  // also the cotangent of o.d
        const float cot_ct = -cot_disc;                    // also the cotangent of o.o
        const float cot_cd = -cot_b;
        c[R_FORM] = cot_ct * o.x, c[R_FORM + 1] = cot_ct * o.y, c[R_FORM + 2] = cot_ct * o.z;
        c[R_FORM + 3] = cot_ct;
        c[R_FORM + 4] = cot_cd * d.x, c[R_FORM + 5] = cot_cd * d.y, c[R_FORM + 6] = cot_cd * d.z;
        cot_o_in = add(cot_o_in, add(add(scale(o, 2.0f * cot_ct), scale(d, cot_b)),
                                     scale(xyz(fc), cot_ct)));
        cot_d_in = add(cot_d_in, add(scale(o, cot_b), scale(xyz(fd), cot_cd)));
      }
    }

    // the winners' rows: two passes for each winner among the warp's lanes,
    // the winners in the order of their first lanes
    const unsigned peers = __match_any_sync(FULL_WARP, idx);
    for (unsigned left = lanes; left != 0u;) {
      const int lead = __ffs(left) - 1;
      const unsigned group = __shfl_sync(FULL_WARP, peers, lead);
      const int win = __shfl_sync(FULL_WARP, idx, lead);
      left &= ~group;
      const bool mine = (group >> lane) & 1u;
#pragma unroll
      for (int half = 0; half < R_ALL / ROWS; ++half) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) col[r * PITCH] = mine ? c[ROWS * half + r] : 0.0f;
        flush<kFixed>(tb, winner_addr(s, tb, ROWS * half + lane, win));
      }
    }

    cot_o = cot_o_in;
    cot_d = cot_d_in;
    cot_thr = cot_thr_in;
  }

  // the camera ray: o = eye, d = normalize(fwd + right sx + up sy); its 12
  // values are globals 0-11 (eye, fwd, right, up), one pass
  const V3 cot_graw = nd > 0 ? nrm_bwd(cam.graw, cot_d) : V3{0.0f, 0.0f, 0.0f};
  const float gr[3] = {cot_graw.x, cot_graw.y, cot_graw.z};
  col[0] = cot_o.x, col[PITCH] = cot_o.y, col[2 * PITCH] = cot_o.z;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    col[(3 + j) * PITCH] = gr[j];
    col[(6 + j) * PITCH] = cam.sx * gr[j];
    col[(9 + j) * PITCH] = cam.sy * gr[j];
  }
  flush<kFixed>(tb, lane < 12 ? lane : -1);
}

}  // namespace tpurt
