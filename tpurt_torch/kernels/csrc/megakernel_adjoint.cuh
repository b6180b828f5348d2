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
// Summing: one flat table of n floats, [globals | tri_forms | sph_forms |
// attrs].  Up to 12288 floats (48 KB) each block keeps it in shared memory,
// the persistent blocks write one row of partials each, and reduce_rows adds
// the rows in order.  A larger table (the phase-1 limit is 4096 + 4096
// primitives, 368k floats) does not fit a block, so every block adds with
// atomicAdd into one zeroed row in device memory.  Either way a warp first
// sums its 32 lanes by shuffles and makes one atomic add where all its lanes add
// to the same row, which is the common case away from silhouettes.  The order
// of the atomics varies from run to run, so the last bits of a sum do too.

#pragma once

#include "megakernel_common.cuh"

namespace tpurt {

constexpr int MAX_DEPTHS = 16;  // residuals a thread keeps: max_depth + 1 <= 16
constexpr unsigned FULL_WARP = 0xffffffffu;

struct Tables {
  float* acc;  // n floats: a block's shared memory, or the one row in device memory
  int off_tri, off_sph, off_attr, n;
};

__host__ __device__ inline int table_floats(int n_tris, int n_sph, int n_lights) {
  return NGLOB_BASE + 6 * n_lights + 12 * n_tris + 8 * n_sph + ACOLS * (n_tris + n_sph);
}

// Every thread of the block calls this before its first pixel.
__device__ __forceinline__ Tables tables_begin(const Scene& s, float* smem, float* partials,
                                               int use_shared) {
  Tables tb;
  tb.off_tri = NGLOB_BASE + 6 * s.n_lights;
  tb.off_sph = tb.off_tri + 12 * s.n_tris;
  tb.off_attr = tb.off_sph + 8 * s.n_sph;
  tb.n = table_floats(s.n_tris, s.n_sph, s.n_lights);
  if (use_shared) {
    for (int j = threadIdx.x; j < tb.n; j += blockDim.x) smem[j] = 0.0f;
    __syncthreads();
    tb.acc = smem;
  } else {
    tb.acc = partials;
  }
  return tb;
}

// Every thread of the block calls this after its last pixel.
__device__ __forceinline__ void tables_end(const Tables& tb, float* partials, int use_shared) {
  if (!use_shared) return;
  __syncthreads();
  float* row = partials + static_cast<long long>(blockIdx.x) * tb.n;
  for (int j = threadIdx.x; j < tb.n; j += blockDim.x) row[j] = tb.acc[j];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
  return v;
}

// all 32 lanes add to the same address
__device__ __forceinline__ void add_uniform(float* addr, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(addr, v);
}

// lanes with `on` add v at `mine`; where all of them share a row (`same`),
// the warp sums first and lane `lead`, one of them, adds
__device__ __forceinline__ void add_row(float* mine, bool on, bool same, int lead, float v) {
  if (same) {
    v = warp_sum(on ? v : 0.0f);
    if ((threadIdx.x & 31) == lead) atomicAdd(mine, v);
  } else if (on && v != 0.0f) {
    atomicAdd(mine, v);
  }
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
// passes nd = 0.  occ[k * stride] holds the occlusion bits of depth k; ca0..2
// is the cotangent of the radiance before the clip.
__device__ inline void sweep_reverse(const Scene& s, const Tables& tb, const Residual* res, int nd,
                              const int* occ, long long stride, int shadows, float ca0,
                              float ca1, float ca2, const CameraRay& cam) {
  const float* g = s.glob;
  const int L = s.n_lights;
  const V3 ambient = ld3(g + 12);
  V3 cot_o{0.0f, 0.0f, 0.0f}, cot_d{0.0f, 0.0f, 0.0f};
  float cot_thr = 0.0f;
  const int kmax = __reduce_max_sync(FULL_WARP, nd);
  for (int k = kmax - 1; k >= 0; --k) {
    const int idx = k < nd ? res[k].idx : -1;
    const bool act = idx >= 0;  // a shaded point: the adjoint runs
    if (k < nd && !act) {
      // the path's last depth missed: accum += thr * background
      cot_thr = ca0 * BG0 + ca1 * BG1 + ca2 * BG2;
    }
    const unsigned lanes = __ballot_sync(FULL_WARP, act);
    if (lanes == 0u) continue;
    const int lead = __ffs(lanes) - 1;
    const int idx0 = __shfl_sync(FULL_WARP, idx, lead);
    const bool same = __all_sync(FULL_WARP, !act || idx == idx0);
    const bool is_tri = act && idx < s.n_tris;
    const float* a = s.attrs + static_cast<long long>(act ? idx : 0) * ACOLS;

    // this lane's values; they stay zero on a lane without a shaded point
    V3 o{}, d{}, p{}, n{}, view{}, ka{}, kd{}, ks{}, csh{};
    V3 gsum{}, psub{}, n0{}, n1{}, n2{};
    float t = 0.0f, u = 0.0f, v = 0.0f, w = 1.0f, thr = 0.0f, shin = 0.0f, refl_a = 0.0f;
    bool flip = false, first = false;
    int bits = 0;
    float col0 = 0.0f, col1 = 0.0f, col2 = 0.0f;
    V3 cot_n{}, cot_p{}, cot_view{};
    float c_n[9] = {}, c_k[9] = {}, c_cen[3] = {}, c_form[12] = {};
    float c_shin = 0.0f, c_refl = 0.0f;

    if (act) {
      const Residual r = res[k];
      o = r.o, d = r.d, t = r.t, u = r.u, v = r.v, thr = r.thr, first = r.first;
      bits = occ[k * stride];
      p = add(o, scale(d, t));
      if (is_tri) {
        w = 1.0f - u - v;
        n0 = ld3(a + A_N0), n1 = ld3(a + A_N1), n2 = ld3(a + A_N2);
        gsum = add(scale(n0, w), add(scale(n1, u), scale(n2, v)));
        const V3 ni = normalize(gsum);
        flip = dot(ni, d) > 0.0f;
        n = flip ? neg(ni) : ni;
      } else {
        psub = sub(p, ld3(a + A_CENTER));
        n = normalize(psub);
      }
      ka = ld3(a + A_KA), kd = ld3(a + A_KD), ks = ld3(a + A_KS);
      shin = __ldg(a + A_SHIN);
      refl_a = __ldg(a + A_REFL);
      view = neg(d);
      c_refl = cot_thr * thr;                       // thr' = thr * refl
      csh = {ca0 * thr, ca1 * thr, ca2 * thr};      // accum += thr * colour
      col0 = ka.x * ambient.x, col1 = ka.y * ambient.y, col2 = ka.z * ambient.z;
    }

    for (int li = 0; li < L; ++li) {
      float d_lpos[3] = {}, d_lcol[3] = {};
      if (act) {
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
        c_k[3] += lc.x * ndotl, c_k[4] += lc.y * ndotl, c_k[5] += lc.z * ndotl;  // kd
        c_k[6] += lc.x * spec, c_k[7] += lc.y * spec, c_k[8] += lc.z * spec;     // ks
        const float cot_ndotl = lc.x * kd.x + lc.y * kd.y + lc.z * kd.z;
        const float cot_spec = lc.x * ks.x + lc.y * ks.y + lc.z * ks.z;
        d_lcol[0] = vis * s0 * csh.x, d_lcol[1] = vis * s1 * csh.y, d_lcol[2] = vis * s2 * csh.z;

        // pow's two adjoints, both under the spec mask
        float cot_srv = 0.0f;
        if (specmask) {
          cot_srv = shin * powf(safe_rv, shin - 1.0f) * cot_spec;
          c_shin += spec * logf(safe_rv) * cot_spec;
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
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        add_uniform(tb.acc + NGLOB_BASE + 3 * li + j, d_lpos[j]);
        add_uniform(tb.acc + NGLOB_BASE + 3 * L + 3 * li + j, d_lcol[j]);
      }
    }

    float d_amb[3] = {};
    V3 cot_o_in{}, cot_d_in{};
    float cot_thr_in = cot_thr;  // a miss set it above; a dead lane keeps zero
    if (act) {
      cot_thr_in = cot_thr * refl_a + (ca0 * col0 + ca1 * col1 + ca2 * col2);
      c_k[0] = ambient.x * csh.x, c_k[1] = ambient.y * csh.y, c_k[2] = ambient.z * csh.z;
      d_amb[0] = ka.x * csh.x, d_amb[1] = ka.y * csh.y, d_amb[2] = ka.z * csh.z;

      // the next ray: o' = p + eps n, d' = reflect(d, n); view = -d
      cot_p = add(cot_p, cot_o);
      cot_n = add(cot_n, scale(cot_o, RAY_OFFSET_EPS));
      V3 cot_n_r2;
      refl_bwd(d, n, cot_d, cot_d_in, cot_n_r2);
      cot_n = add(cot_n, cot_n_r2);
      cot_d_in = sub(cot_d_in, cot_view);

      float cot_u = 0.0f, cot_v = 0.0f;
      if (is_tri) {
        const V3 cot_g = nrm_bwd(gsum, flip ? neg(cot_n) : cot_n);
        c_n[0] = cot_g.x * w, c_n[1] = cot_g.y * w, c_n[2] = cot_g.z * w;
        c_n[3] = cot_g.x * u, c_n[4] = cot_g.y * u, c_n[5] = cot_g.z * u;
        c_n[6] = cot_g.x * v, c_n[7] = cot_g.y * v, c_n[8] = cot_g.z * v;
        cot_u = dot(sub(n1, n0), cot_g);
        cot_v = dot(sub(n2, n0), cot_g);
      } else {
        const V3 cot_psub = nrm_bwd(psub, cot_n);
        cot_p = add(cot_p, cot_psub);
        c_cen[0] = -cot_psub.x, c_cen[1] = -cot_psub.y, c_cen[2] = -cot_psub.z;
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
          c_form[4 * r + 0] = co[r] * o.x + cd[r] * d.x;
          c_form[4 * r + 1] = co[r] * o.y + cd[r] * d.y;
          c_form[4 * r + 2] = co[r] * o.z + cd[r] * d.z;
          c_form[4 * r + 3] = co[r];
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
        c_form[0] = cot_ct * o.x, c_form[1] = cot_ct * o.y, c_form[2] = cot_ct * o.z;
        c_form[3] = cot_ct;
        c_form[4] = cot_cd * d.x, c_form[5] = cot_cd * d.y, c_form[6] = cot_cd * d.z;
        cot_o_in = add(cot_o_in, add(add(scale(o, 2.0f * cot_ct), scale(d, cot_b)),
                                     scale(xyz(fc), cot_ct)));
        cot_d_in = add(cot_d_in, add(scale(o, cot_b), scale(xyz(fd), cot_cd)));
      }
    }

    // into the tables: ambient, then the winner's attribute and form rows
#pragma unroll
    for (int j = 0; j < 3; ++j) add_uniform(tb.acc + 12 + j, d_amb[j]);
    const bool tris = !same || idx0 < s.n_tris;   // some lane may hold a triangle
    const bool sphs = !same || idx0 >= s.n_tris;  // some lane may hold a sphere
    float* arow = tb.acc + tb.off_attr + static_cast<long long>(act ? idx : 0) * ACOLS;
    float* frow = is_tri ? tb.acc + tb.off_tri + 12LL * idx
                         : tb.acc + tb.off_sph + 8LL * (act ? idx - s.n_tris : 0);
    if (tris) {
#pragma unroll
      for (int j = 0; j < 9; ++j) add_row(arow + A_N0 + j, act, same, lead, c_n[j]);
    }
#pragma unroll
    for (int j = 0; j < 9; ++j) add_row(arow + A_KA + j, act, same, lead, c_k[j]);
    add_row(arow + A_SHIN, act, same, lead, c_shin);
    add_row(arow + A_REFL, act, same, lead, c_refl);
    if (sphs) {
#pragma unroll
      for (int j = 0; j < 3; ++j) add_row(arow + A_CENTER + j, act, same, lead, c_cen[j]);
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      // a sphere's form rows hold 8 floats: its c_form[8..11] are zero and
      // are never added
      if (j < 8 || tris) add_row(frow + j, act, same, lead, c_form[j]);
    }

    cot_o = cot_o_in;
    cot_d = cot_d_in;
    cot_thr = cot_thr_in;
  }

  // the camera ray: o = eye, d = normalize(fwd + right sx + up sy)
  const V3 cot_graw = nd > 0 ? nrm_bwd(cam.graw, cot_d) : V3{0.0f, 0.0f, 0.0f};
  const float eye[3] = {cot_o.x, cot_o.y, cot_o.z};
  const float gr[3] = {cot_graw.x, cot_graw.y, cot_graw.z};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    add_uniform(tb.acc + j, eye[j]);
    add_uniform(tb.acc + 3 + j, gr[j]);
    add_uniform(tb.acc + 6 + j, cam.sx * gr[j]);
    add_uniform(tb.acc + 9 + j, cam.sy * gr[j]);
  }
}

}  // namespace tpurt
