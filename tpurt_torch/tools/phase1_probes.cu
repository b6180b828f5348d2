// Probe kernels for tools/phase1_times.py --pieces: one piece of the phase-1
// forward body a kernel, compiled alone with the library's nvcc flags, so
// that cuobjdump counts the instructions of that piece.  Built against the
// csrc directory of the package that is imported, this checkout's or another
// one's; -DTPURT_LEGACY_PHASE1 for one from before phase1_math.cuh, whose
// body used the unfused helpers of megakernel_common.cuh (those branches
// repeat that body's lines).
//
// Inputs: in[0..2] a point or origin, in[3..5] a normal or direction,
// in[6..8] a direction, in[9] a distance bound or the shininess.

#ifdef TPURT_LEGACY_PHASE1
#include "megakernel_common.cuh"
#else
#include "phase1_math.cuh"
#endif

using namespace tpurt;

#define PROBE(name)                                                                \
  extern "C" __global__ void probe_##name(Scene s, Frame f, const float* __restrict__ in, \
                                          float* __restrict__ out)

// what every probe pays to read its inputs and write three outputs
PROBE(base) {
  out[0] = in[0];
  out[1] = in[1];
  out[2] = in[2];
}

// one closest-hit test of triangle 0 (tmax: the best hit so far)
PROBE(tri_test) {
  const V3 o = ld3(in), d = ld3(in + 3);
  float u = 0.0f, v = 0.0f;
#ifdef TPURT_LEGACY_PHASE1
  const float t = tri_t(s, 0, o, d, u, v);
#else
  const float t = p1_tri_t(s, 0, o, d, in[9], u, v);
#endif
  out[0] = t;
  out[1] = u;
  out[2] = v;
}

// one test of sphere 0, o.o and o.d given
PROBE(sph_test) {
  const V3 o = ld3(in), d = ld3(in + 3);
  bool first = false;
#ifdef TPURT_LEGACY_PHASE1
  const float t = sph_t(s, 0, o, d, in[6], in[7], first);
#else
  const float t = p1_sph_t(s, 0, o, d, in[6], in[7], first);
#endif
  out[0] = t;
  out[1] = first ? 1.0f : 0.0f;
  out[2] = 0.0f;
}

// the shading of light 0 at point p with normal n seen along view, without
// its shadow test: the colour's increment and the shadow ray's direction and
// length
PROBE(light) {
  const V3 p = ld3(in), n = ld3(in + 3), view = ld3(in + 6);
  const float shin = in[9];
  const float* a = s.attrs;
  const V3 kd = ld3(a + A_KD), ks = ld3(a + A_KS);
  const float* g = s.glob;
  const int L = s.n_lights;
  const V3 lpos = ld3(g + NGLOB_BASE), lcol = ld3(g + NGLOB_BASE + 3 * L);
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  const float vis = 1.0f;
#ifdef TPURT_LEGACY_PHASE1
  const V3 to_l = sub(lpos, p);
  const float dist = sqrtf(dot(to_l, to_l));
  const V3 ldir = scale(to_l, 1.0f / fmaxf(dist, 1e-20f));
  const float ndotl = fmaxf(dot(n, ldir), 0.0f);
  const V3 refl_l = reflect(neg(ldir), n);
  const float rdotv = fmaxf(dot(refl_l, view), 0.0f);
  const float safe_rv = rdotv > 0.0f ? rdotv : 1.0f;
  const float spec = (ndotl > 0.0f && rdotv > 0.0f) ? powf(safe_rv, shin) : 0.0f;
  c0 = c0 + vis * lcol.x * (kd.x * ndotl + ks.x * spec);
  c1 = c1 + vis * lcol.y * (kd.y * ndotl + ks.y * spec);
  c2 = c2 + vis * lcol.z * (kd.z * ndotl + ks.z * spec);
#else
  const LightTerms l = light_terms(lpos, p, n, view, shin);
  const V3 ldir = l.ldir;
  const float dist = l.dist;
  c0 = __fmaf_rn(vis * lcol.x, p1_phong(kd.x, ks.x, l), c0);
  c1 = __fmaf_rn(vis * lcol.y, p1_phong(kd.y, ks.y, l), c1);
  c2 = __fmaf_rn(vis * lcol.z, p1_phong(kd.z, ks.z, l), c2);
#endif
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = ldir.x;
  out[4] = ldir.y;
  out[5] = ldir.z;
  out[6] = dist - RAY_OFFSET_EPS;
}

// the camera ray of pixel in[0]
PROBE(raygen) {
  const int pix = static_cast<int>(in[0]);
#ifdef TPURT_LEGACY_PHASE1
  const CameraRay r = raygen(s, f, pix);
#else
  const CameraRay r = p1_raygen(DeviceGlobals{s.glob}, f, pix);
#endif
  out[0] = r.d.x;
  out[1] = r.d.y;
  out[2] = r.d.z;
}

// the specular power as the body computes it
PROBE(spec_pow) {
#ifdef TPURT_LEGACY_PHASE1
  out[0] = powf(in[0], in[1]);
#else
  out[0] = p1_pow(in[0], in[1]);
#endif
}

// the library's sequences, as the body calls them
PROBE(powf) { out[0] = powf(in[0], in[1]); }
PROBE(div) { out[0] = in[0] / in[1]; }
PROBE(rcp) { out[0] = 1.0f / fmaxf(in[0], 1e-20f); }
PROBE(sqrtf) { out[0] = sqrtf(in[0]); }
PROBE(rsqrtf) { out[0] = rsqrtf(in[0]); }
